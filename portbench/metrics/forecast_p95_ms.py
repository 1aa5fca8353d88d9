"""forecast_p95_ms: the 95th percentile of all the window's requests,
each timed on the host from the call to its result (a synchronize)."""

import statistics


def read(run):
    if run.mode != 'forecast' or not run.latencies_s:
        return None
    lat = run.latencies_s
    p95 = statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]
    return p95 * 1e3
