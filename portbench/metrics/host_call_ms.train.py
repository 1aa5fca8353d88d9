"""host_call_ms.train: the host's wall time inside one epoch's call of
the train segment (its steps and the monitoring eval), before the
synchronise, per train step: the median over the window's calls outside
the traced slice (host clock). While the card idles between launches, as
in these host-paced cells, it is the host's cost of issuing the work;
were the launch queue ever full, it would include the wait for the
card."""

import statistics


def read(run):
    if run.mode != 'train' or not run.call_s:
        return None
    return statistics.median(run.call_s) / run.units_per_call * 1e3
