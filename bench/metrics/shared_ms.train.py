"""Device milliseconds a step inside the published Zamba2's hybrid sites,
the shared blocks with their adapters and linears, forward and backward:
the program's marks at each site's entry and exit (``models/zamba2.py``),
the median over the steps after the traced ones."""


def read(rec):
    marks = rec.get("marks")
    return None if not marks else marks.get("shared_ms")
