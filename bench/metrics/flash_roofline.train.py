"""The flash forward's least time a call at the published Zamba2's site
shapes (its operations at the bf16 dense peak or its bytes at the HBM
peak, the larger; ``bench/harness/counts_zamba2.py``) over the trace
seconds of ``flash_wgmma_kernel`` a call (%)."""


def read(rec):
    tr, b = rec.get("trace"), rec.get("bounds")
    if not tr or not b or "flash_s" not in b or not tr.get("flash_wgmma_s"):
        return None
    per_call = tr["flash_wgmma_s"] / (tr["steps"] * b["flash_calls_per_step"])
    return 100.0 * b["flash_s"] / per_call
