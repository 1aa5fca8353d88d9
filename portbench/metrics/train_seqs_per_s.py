"""train_seqs_per_s: training sequences of the steps that completed
(finite loss, update applied) over the window's wall time, which ends in
a synchronize (host clock)."""


def read(run):
    if run.mode != 'train':
        return None
    return run.seqs / run.window_s
