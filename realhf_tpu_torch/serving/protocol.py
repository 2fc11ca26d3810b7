"""Rollout protocol constants: the event kinds and reason strings the
scheduler (``serving/scheduler.py``) and the request queue emit, and the
terminal kinds a rollout client reports.

The request kinds, the frame schemas, the client/router/gateway state
machines and the router's and gateway's reasons come with the transport
of the distributed-runtime slice of the port, which reads them.
"""

STARTED = "started"
TOKENS = "tokens"
DONE = "done"
REJECTED = "rejected"
STALE = "stale"
EXPIRED = "expired"
CANCELLED = "cancelled"
DRAINING = "draining"

#: kinds that end a request's stream; only DONE carries an answer, the
#: others are backpressure or teardown
TERMINAL_KINDS = (DONE, REJECTED, STALE, EXPIRED, CANCELLED, DRAINING)

# the ``reason=`` of a rejected or expired request
# admission verdicts (serving/request_queue.py)
REASON_DRAINING = "draining"
REASON_EXPIRED = "expired"
REASON_PROMPT_TOO_LONG = "prompt_too_long"
REASON_WEIGHTS_BEHIND = "weights_behind"
REASON_BACKPRESSURE = "backpressure"
# scheduler-side rejections (serving/scheduler.py)
REASON_FILL_FAILED = "fill_failed"
REASON_KV_OOM = "kv_oom"
