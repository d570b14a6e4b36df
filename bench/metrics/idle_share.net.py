"""The share of the traced part of the window in which no operation ran
on the device (%; on several cards, their mean)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
