"""The window's forward operations (every convolution and the classifier,
counted from the configuration's shapes) over the window's seconds, as a
share of the 3xTF32 peak the float32 network path runs on (%)."""


def read(rec):
    net, b = rec.get("net"), rec.get("bounds")
    if not net or not b:
        return None
    return 100.0 * net["passes"] * net["flops_per_pass"] \
        / net["window_s"] / b["flops_s"]
