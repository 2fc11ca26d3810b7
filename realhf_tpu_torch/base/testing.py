"""Testing utilities shipped with the package (picklable across
processes)."""


class IntegerTokenizer:
    """Deterministic word-hash tokenizer for tests and random-weight
    runs: no vocabulary files and no network."""

    pad_token_id = 0
    eos_token_id = 1
    eos_token = " zEOSz"
    padding_side = "left"

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size

    def __call__(self, texts, truncation=False, max_length=None,
                 padding=False, return_length=False,
                 return_attention_mask=False, **kw):
        ids = [[2 + (sum(map(ord, w)) % self.vocab_size)
                for w in t.split()] for t in texts]
        if truncation and max_length:
            ids = [x[:max_length] for x in ids]
        out = {"input_ids": ids}
        if return_length:
            out["length"] = [len(x) for x in ids]
        return out

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))
