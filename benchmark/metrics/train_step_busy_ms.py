"""train_step_busy_ms: device-busy milliseconds per training step in the
traced slice (the union of the device's events over the slice's steps)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 1e3 * prof["busy_s"] / prof["units"]
