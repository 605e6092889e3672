"""The check of a locked-grid receiver's frames: what decides `correct` in
a cell whose receiver returns frame tuples (channel, bytes, metric,
sync quality, position) and keeps the locked engine's public lock state.

`state(engine)` is copied after every call of the window; `compare` then
holds the window's output to what the generator sent and to the plain
reference (portbench/reference.py):

    wrong_share     frames emitted at a transmitted frame's position
                    (within half a symbol) with other bytes, or a second
                    time, over the frames emitted at transmitted positions
    missed_share    transmitted frames of the blocks the window returned
                    that no emitted frame carries, over those frames
    spurious_share  frames emitted at no transmitted position, over every
                    frame emitted; the flywheel's frames (on the channel's
                    grid where it sent nothing, sync quality under 0.70,
                    which the lifecycle emits for up to 5 misses) excepted
    timing_bias     |the median|, over every (call, channel) that the
                    state after a timed call holds locked without a miss,
                    of the samples by which the program's timing p0 + frac
                    lies after the true one (the sync + 0.5, the centre of
                    the correlation's 2-sample apex; mod a frame): a biased
                    estimator moves it, the estimates' noise (+-1 sample at
                    12 dB) cancels, a false lock weighs as one state
    cfo_bias_hz     the same of freq_offset less the true offset, Hz
                    (+-150 Hz a single estimate at 12 dB)
    metric_gap      share of a sample of emitted frames of steady
                    blocks whose Viterbi path metric differs from the
                    reference's, computed from the generated samples at the
                    grid, timing and carrier offset of the state the block
                    launched with.  An acquisition block's frames are not
                    sampled: the state it decoded with is refined (the
                    warming retime) in the call that returns it, before a
                    copy can be taken; the hunt's estimates are held to the
                    truth by timing_bias and cfo_bias_hz instead, its
                    positions by the frames' positions, its frames' bytes
                    by wrong_share
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import generator, reference as ref
from portbench.cell import launch_call

#: the reference's frames a batch (memory: ~1.4 MB of complex128 a frame)
REF_BATCH = 128
#: the lifecycle's locked re-check threshold (opv-demod.cpp:695-713)
LOCKED_Q = 0.70


def state(engine) -> tuple:
    return (engine.locked.copy(), engine.miss.copy(), engine.p0.copy(),
            engine.frac.copy(), engine.freq_offset.copy())


def _wrap(d: np.ndarray) -> np.ndarray:
    """Distances mod a frame, into [-SPF/2, SPF/2)."""
    return (d + ref.SPF / 2) % ref.SPF - ref.SPF / 2


def estimate_errors(tr, win) -> tuple:
    """The signed errors of the locked states of the window's calls against
    the generator's truth: (timing in samples, carrier offset in Hz)."""
    t_err, f_err = [], []
    truth = tr.sync_at + 0.5
    for i in range(win.first, win.drain + 1):
        locked, miss, p0, frac, foff = win.states[i]
        on = locked & (miss == 0)
        if on.any():
            t = p0[on].astype(np.float64) + frac[on]
            t_err.append(_wrap(t - truth[on]))
            f_err.append(foff[on].astype(np.float64) - tr.cfo_hz[on])
    if not t_err:
        return np.array([np.inf]), np.array([np.inf])
    return np.concatenate(t_err), np.concatenate(f_err)


def compare(tr, win, seed: int, limits: dict, g: dict, device) -> dict:
    """The numbers that decide `correct`, each beside its limit."""
    adv = g["advance"]
    seen = {}
    corrupt = emitted = spurious = total = 0
    bad = []
    rows = []
    for i in range(win.first, win.drain + 1):
        by_block = {}
        for t in win.results[i]:
            by_block.setdefault((t[4] // adv, t[0]), []).append(t)
        for (b, c), ts in by_block.items():
            # a lock dropped inside the block re-hunts after a run of
            # flywheel frames (sync quality under 0.70): frames before the
            # block's first one were decoded with the state it launched with
            fly = min((t[4] for t in ts if t[3] < LOCKED_Q), default=None)
            for (_, fb, met, q, pos) in ts:
                total += 1
                j = tr.frame_at(c, pos)
                if j is None or not tr.sent(c, j):
                    if j is None or q >= LOCKED_Q:
                        spurious += 1
                    continue
                emitted += 1
                if (c, j) in seen or fb != tr.payload(c, j):
                    corrupt += 1
                    if len(bad) < 12:
                        bad.append(dict(
                            channel=c, frame=j, dup=(c, j) in seen,
                            pos_off=pos - int(round(tr.sync_at[c]))
                            - j * ref.SPF, metric=met, q=round(q, 4),
                            bytes_wrong=sum(a != b for a, b in zip(
                                fb, tr.payload(c, j)))))
                seen[(c, j)] = True
                lc = launch_call(b, g)
                if (fly is not None and pos >= fly) or lc not in win.states \
                        or lc >= win.drain:
                    continue
                lock_at = win.states[lc if g["pipeline"] else lc - 1]
                if not (lock_at[0][c] and lock_at[1][c] == 0):
                    continue              # an acquisition block's frame
                st = win.states[lc]
                if (pos - b * adv - int(st[2][c])) % ref.SPF:
                    continue              # the state does not place it
                rows.append((c, pos, met, q, float(st[3][c]),
                             float(st[4][c])))
    # the frames due: every transmitted frame owned by a block that a timed
    # call returned (a block is returned by the call after the one that
    # launched it when pipelined, by that call when not; flush() returns
    # the last launched one)
    ret = [b for b in range(win.drain + 2)
           if win.first <= launch_call(b, g) + g["pipeline"] <= win.drain
           and launch_call(b, g) < win.drain]
    due = missed = 0
    missed_by = {}
    if ret:
        lo, hi = ret[0] * adv, (ret[-1] + 1) * adv
        for c in range(tr.channels):
            s0 = int(round(tr.sync_at[c]))
            for j in range(max(0, -(-(lo - s0) // ref.SPF)),
                           (hi - 1 - s0) // ref.SPF + 1):
                if tr.sent(c, j):
                    due += 1
                    if (c, j) not in seen:
                        missed += 1
                        missed_by[c] = missed_by.get(c, 0) + 1
    gap, qgap, n_cmp = _metric_gap(tr, rows, seed,
                                   limits.get("sample_frames", 768), device)
    t_err, f_err = estimate_errors(tr, win)
    t_bias, f_bias = (abs(float(np.median(e))) for e in (t_err, f_err))
    nums = {"wrong_share": (corrupt / emitted if emitted else 1.0,
                            limits["wrong_share"]),
            "missed_share": (missed / due if due else 1.0,
                             limits["missed_share"]),
            "spurious_share": (spurious / total if total else 1.0,
                               limits["spurious_share"]),
            "timing_bias": (t_bias, limits["timing_bias"]),
            "cfo_bias_hz": (f_bias, limits["cfo_bias_hz"]),
            "metric_gap": (gap, limits["metric_gap"])}
    ok = all(v <= lim for v, lim in nums.values()) and n_cmp > 0 and due > 0
    return dict(correct=bool(ok), attempted=due, failed=missed + corrupt,
                numbers=nums, compared=n_cmp, eligible=len(rows),
                sync_q_gap=qgap, corrupt_frames=bad,
                estimates=_spread(t_err, f_err),
                missed_by_channel=dict(sorted(missed_by.items(),
                                              key=lambda kv: -kv[1])[:8]))


def _spread(t_err, f_err) -> dict:
    """The estimates' signed errors at their 10th, 50th and 90th
    percentiles, and how many locked states they cover (for the log)."""
    pct = [10, 50, 90]
    return dict(states=int(t_err.size),
                timing=[round(float(x), 4) for x in np.percentile(t_err, pct)],
                cfo_hz=[round(float(x), 2) for x in np.percentile(f_err, pct)])


def _metric_gap(tr, rows, seed, n, device):
    if not rows:
        return 1.0, float("nan"), 0
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rows), size=min(n, len(rows)), replace=False)
    sel = [rows[k] for k in sorted(pick)]
    ys = generator.channel_samples(tr, device)
    mism = 0
    qgap = 0.0
    for a in range(0, len(sel), REF_BATCH):
        part = sel[a:a + REF_BATCH]
        seg = torch.stack([segment(tr, ys, c, pos) for c, pos, *_ in part])
        frac = torch.tensor([r[4] for r in part], dtype=torch.float64)
        foff = torch.tensor([r[5] for r in part], dtype=torch.float64)
        soft = ref.soft_values(seg, frac, foff)
        q = ref.sync_quality(soft).cpu().numpy()
        met = ref.viterbi_metric(ref.quantize(soft[:, ref.SYNC_BITS:]))
        met = met.cpu().numpy()
        mism += int(sum(m != r[2] for m, r in zip(met, part)))
        got = np.array([r[3] for r in part])
        qgap = max(qgap, float(np.max(np.abs(q - got))))
    return mism / len(sel), qgap, len(sel)


def segment(tr, ys, c: int, pos: int) -> torch.Tensor:
    """Channel c's samples [pos, pos + one frame + 41) as the reference
    sees them, complex128."""
    length = ref.SPF + ref.SPS + 1
    if ys is not None:
        period = ys.shape[1]
        idx = (pos + torch.arange(length, device=ys.device)) % period
        return ys[c, idx]
    adv = tr.feed_channel_samples
    period = adv * len(tr.feeds)
    out, at, left = [], pos % period, length
    while left:
        f, o = divmod(at, adv)
        take = min(left, adv - o)
        out.append(tr.feeds[f][c, o:o + take])
        at = (at + take) % period
        left -= take
    return torch.cat(out).to(torch.complex128)
