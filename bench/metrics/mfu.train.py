"""The window's training operations (3 x the forward's: the products by
every weight, each shared-block use counted, plus the scan's and
attention's, from the configuration's shapes) over the window's seconds,
as a share of the bf16 dense peak of the cell's cards (%)."""


def read(rec):
    t = rec.get("train")
    if not t:
        return None
    return 100.0 * t["steps"] * t["flops_per_step"] / t["window_s"] \
        / (t["peak_flops_s"] * t["chips"])
