"""Rollout protocol constants: the terminal status kinds of a
generation request, as a rollout client reports them.

Only what the agentic episode loop reads; the request kinds, reasons
and message framing of the serving stack come with its slice of the
port.
"""

DONE = "done"
REJECTED = "rejected"
STALE = "stale"
EXPIRED = "expired"
CANCELLED = "cancelled"
DRAINING = "draining"

#: kinds that end a request's stream; only DONE carries an answer, the
#: others are backpressure or teardown
TERMINAL_KINDS = (DONE, REJECTED, STALE, EXPIRED, CANCELLED, DRAINING)
