"""forecast_seqs_per_s: sequences of the requests that came back with
finite frames over the window's wall time, which ends in a synchronize
(host clock)."""


def read(run):
    if run.mode != 'forecast':
        return None
    return run.seqs / run.window_s
