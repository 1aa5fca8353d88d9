"""Mode 'forecast': a closed loop of one client sending batched requests
to the port's forecaster (`make_forecast_fn`), each `fn(X, seed)` and a
synchronize, the next sent when the last has come back.

Traffic keys: batch, pool (sequences the requests draw from), L,
sample_requests and sample_span (the requests the check compares, drawn
from the seed among the window's first `sample_span`, and the last),
trace_requests (requests in a traced slice), max_requests (requests
drawn for the window).
"""

import time

import torch

from portbench.harness import compare, data, program, trace, weights
from portbench.reference import model as ref


class Mode:
    """Set-up (data, model, two warm-up requests) in the constructor;
    `window(seconds)` measures; `program_numbers()` and `readings()`
    judge once the window has closed."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
        self.B, self.L, self.T = tr['batch'], tr['L'], cfg['T']
        g = data.generator(ctx.seed, data.DATA, dev)
        self.pool = data.rotating_sequences(tr['pool'], self.T, g, dev)
        R = tr['max_requests']
        self.idx = data.permutations(R, tr['pool'], g, dev)[:, :self.B]
        self.seed0 = int(torch.randint(2 ** 40, (1,), generator=g,
                                       device=dev))
        self._refs = {}
        ctx.phase('data')
        self.state0 = weights.initial_state(
            cfg, ctx.root, data.generator(ctx.seed, data.WEIGHTS, dev), dev)
        self.fn = program.forecaster(cfg, ctx.root, self.state0, self.L, dev)
        ctx.phase('model')
        gs = torch.Generator().manual_seed(
            (int(ctx.seed) * 1_000_003 + data.SAMPLE) % (2 ** 63))
        self.sample = set(torch.randperm(tr['sample_span'], generator=gs)[
            :tr['sample_requests']].tolist())
        for r in (R - 1, R - 2):             # the requests' shapes
            self.fn(self.pool[self.idx[r]], self.seed0 + r)
        if ctx.trace:
            prof = trace.profiler(dev)
            prof.start()
            self.fn(self.pool[self.idx[R - 1]], self.seed0 + R - 1)
            data.sync(dev)
            prof.stop()
        data.sync(dev)
        ctx.phase('warm-up')

    def _request(self, r):
        X = self.pool[self.idx[r]]
        t = time.perf_counter()
        out = self.fn(X, self.seed0 + r)
        call = time.perf_counter() - t
        data.sync(self.ctx.device)
        return out, call, time.perf_counter() - t

    def window(self, seconds):
        """Requests until `seconds` have passed, then a synchronize. With
        a trace, `trace_requests` requests at the window's middle are
        traced. Returns the run's raw facts: counts, times, the work of
        one call by its shapes, and the trace."""
        ctx, tr, dev = self.ctx, self.ctx.traffic, self.ctx.device
        lat, call_s, kept = [], [], {}
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        traced, pre = None, (None, None)
        r, last = 0, None

        def serve(traced_now):
            nonlocal r, last, bad
            out, dc, dt = self._request(r)
            lat.append(dt)
            if not traced_now:
                call_s.append(dc)
                if r in self.sample:
                    kept[r] = out.clone()
            bad += ~torch.isfinite(out).all()
            last = (r, out)
            r += 1

        t0 = time.perf_counter()
        while True:
            if r >= tr['max_requests'] - 2:
                raise RuntimeError('the window outran the requests drawn')
            if ctx.trace and traced is None and \
                    time.perf_counter() - t0 >= seconds / 2:
                pre = (r, time.perf_counter() - t0)
                prof = trace.profiler(dev)
                prof.start()
                ts = time.perf_counter()
                for _ in range(tr['trace_requests']):
                    serve(True)
                data.sync(dev)
                span = time.perf_counter() - ts
                prof.stop()
                traced = trace.read(prof, span, tr['trace_requests'],
                                    tr['trace_requests'])
            else:
                serve(False)
            if time.perf_counter() - t0 >= seconds and (
                    traced is not None or not ctx.trace):
                break
        data.sync(dev)
        wall = time.perf_counter() - t0
        kept[last[0]] = last[1]
        self.kept = kept
        failed = int(bad)
        work = [{'kind': 'forward', 'L': self.L, 'N': self.B, 'T': self.T,
                 'count': 1}]
        return dict(mode='forecast', cfg=ctx.cfg, window_s=wall,
                    attempted=r, failed=failed, seqs=(r - failed) * self.B,
                    latencies_s=lat, call_s=call_s, units_per_call=1,
                    work=work, trace=traced, calls_before_trace=pre[0],
                    wall_before_trace_s=pre[1])

    def free(self):
        del self.fn

    def _frames(self, r, prec):
        """The reference's frames of request r: 'f32', 'tf32' (the
        control's products), or 'f64' (every input cast to float64)."""
        dev = self.ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed0 + r)
        noise = ref.draw_noise(self.ctx.cfg, self.B, self.L, gen, dev)
        P, X = self.state0['params'], self.pool[self.idx[r]]
        if prec == 'f64':
            P = {n: t.double() for n, t in P.items()}
            X = X.double()
            noise = {n: t.double() for n, t in noise.items()}
        return ref.forecast(self.ctx.cfg, P, X, noise, self.L,
                            ref.Ops('tf32' if prec == 'tf32' else 'f32'))

    def _ref(self, r):
        if r not in self._refs:
            self._refs[r] = self._frames(r, 'f32')
        return self._refs[r]

    def program_numbers(self):
        gap = max(compare.frames_gap(got, self._ref(r))
                  for r, got in self.kept.items())
        return {'frames_gap': gap, 'requests_compared': len(self.kept)}

    def readings(self):
        """The numbers that set the limits besides the program's: the
        control (the reference with TF32 products in the program's
        place); two faults planted in the reference's answer (the last
        draw's frames replaced by the first draw's; each sequence's
        frames replaced by the next sequence's); and the float64
        reference as a witness, with the program's and the float32
        reference's gaps to it."""
        def widest(f):
            return max(f(r) for r in self.kept)

        def replaced_draw(r):
            got = self._ref(r).clone()
            got[-1] = got[0]
            return compare.frames_gap(got, self._ref(r))

        def shifted_rows(r):
            return compare.frames_gap(self._ref(r).roll(1, dims=1),
                                      self._ref(r))

        f64 = {r: self._frames(r, 'f64') for r in self.kept}
        n = len(self.kept)
        return {
            'control': {'frames_gap': widest(lambda r: compare.frames_gap(
                self._frames(r, 'tf32'), self._ref(r))),
                'requests_compared': n},
            'replaced_draw': {'frames_gap': widest(replaced_draw)},
            'shifted_rows': {'frames_gap': widest(shifted_rows)},
            'f64': {'program': widest(lambda r: compare.frames_gap(
                self.kept[r].double(), f64[r])),
                'reference_f32': widest(lambda r: compare.frames_gap(
                    self._ref(r).double(), f64[r]))}}
