"""K1 and K1b (forward with lse, the backward's launches) device seconds over the device's busy seconds in the traced slice, in %."""

from benchmark.roofline import kernel_device_s


def read(run):
    t = run.traced
    if t is None or t["busy_s"] <= 0 or not t["launches"]:
        return None
    return 100.0 * kernel_device_s(t, ("fwd", "dkv", "dq")) / t["busy_s"]
