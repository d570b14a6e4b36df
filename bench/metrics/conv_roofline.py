"""The convolutions' least time per forward pass (each layer the larger of
its operations at the 3xTF32 peak and its bytes at the HBM peak, from
the configuration's shapes) over the device time of ``conv_kernel`` per
traced replay (%)."""


def read(rec):
    tr, b = rec.get("trace"), rec.get("bounds")
    if not tr or not b:
        return None
    conv_s = tr["by_group"].get("conv", 0.0) / tr["passes"]
    if conv_s <= 0:
        return None
    return 100.0 * b["conv_s"] / conv_s
