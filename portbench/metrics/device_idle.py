"""device_idle.<family> (%, layer "device: one H100"): 1 - the card's busy
time over the wall time of one stretch of steps traced for the card's
work alone (`trace.capture_card`)."""

from portbench.readers import idle_percent


def read(run):
    return idle_percent(run)
