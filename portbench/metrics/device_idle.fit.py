"""device_idle.fit (%, device trace): the share of the traced slice in which
no operation ran on the device.  Layer: device; moves fit_ms."""


def read(run):
    return run.idle_share()
