"""device_idle.cv (%, device trace): the share of the traced slice in which
no operation ran on the device.  Layer: device; moves cv_ms."""


def read(run):
    return run.idle_share()
