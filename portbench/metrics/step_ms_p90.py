"""step_ms_p90 (ms, device trace): the 90th percentile of every window
step's time, each the gap between CUDA events recorded on the stream at
consecutive step starts (the last step closed by one more event)."""


def read(run):
    return run.window.percentile_ms(0.9)
