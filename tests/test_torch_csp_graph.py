"""The CSP step loop as a function of static buffers (`ops.csp._mode_steps`)
and the cache of its captured CUDA graphs (`ops.csp.ModeGraphs`).

On the CPU: `_refine_mode_xv` gives, bit for bit, what the step loop gave
before it was factored out (`old_refine_mode_xv` below, kept as the
oracle), for every mode of the 3:0:2:1 schedule and mode 4, with and
without the termination tolerances; the cache's bookkeeping runs with a
graph that replays by calling the function again (`EagerGraphs`): a
replay with new inputs of the same shape equals a fresh call, no returned
tensor shares storage with a buffer, the key separates the mode, each
shape, the step count, each hyperparameter and the device, the cache
keeps to its bound, dropping its least recently used graph and the
buffers no graph shares any more, a key waits for its second call to be
captured once a graph left the cache unreplayed, zero steps and other
threads than the main one capture nothing, and two threads that replay
one shape with different inputs each get their own result.

The `cuda`-marked tests capture real graphs on a card and skip where there
is none: the graph path equals the eager step function bit for bit for
every mode of 3:0:2:1 at its capture and at a replay with new inputs; the
counters count captures, replays and the gather's and the score's kernel
launches of each replay, as many as the profiler sees run; two threads
share the cache while one also works on the card eagerly; and a whole
`csp_refine_batch` with graphs equals one whose steps run eagerly. They
need no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_csp_graph.py
"""

import math
import threading

import pytest
import torch

from pyp_tpu_torch.ops import csp, fourier_slice, kernels, refine3d

S, T, P, BOX, PIXEL = 2, 6, 5, 16, 4.0
MODES = (3, 0, 2, 1)
KW = dict(voltage_kv=300.0, cs_mm=2.7, amplitude_contrast=0.07)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def old_refine_mode_xv(params, xv, window_centers, tilt_defocus, mask_pts,
                       Fref, tilt_weights, valid, mode, n, pixel_size, iters,
                       lr, reg_weight, voltage_kv, cs_mm, amplitude_contrast,
                       step_tol=0.0, value_tol=0.0):
    """The mode refinement as it was written before its steps became a
    function of static buffers (spans left out: they change no value), and
    besides its result the parameters its steps reached."""
    blocks = csp.MODE_BLOCKS[mode]
    lead_shape = params.tilt_angles.shape[:-1]
    with torch.no_grad():
        u0 = (csp._csp_model_gather(params, mask_pts, Fref, n)
              if mode in csp.SHIFT_MODES else None)
        df0 = (csp._csp_df(params, tilt_defocus, pixel_size)
               if mode in csp.CTF_CONST_MODES else None)
        m = {k: torch.zeros_like(getattr(params, k)) for k in blocks}
        done = torch.zeros(lead_shape, device=xv.device)
        prev = torch.full(lead_shape, -math.inf, device=xv.device)

    def loss_fn(p):
        score = csp.csp_score(
            p, xv, window_centers, tilt_defocus, mask_pts, Fref,
            tilt_weights, valid, n, pixel_size, voltage_kv, cs_mm,
            amplitude_contrast, xv_precomputed=True, u=u0, df=df0)
        reg = (csp._smoothness_penalty(p.tilt_shifts)
               + csp._smoothness_penalty(p.tilt_angles[..., None]))
        return score - reg_weight * reg

    def value_and_grad(p):
        leaves = {k: getattr(p, k).detach().requires_grad_(True)
                  for k in blocks}
        with torch.enable_grad():
            loss = loss_fn(p._replace(**leaves))
            g = torch.autograd.grad(loss.sum(), [leaves[k] for k in blocks])
        return loss.detach(), dict(zip(blocks, g))

    use_tols = step_tol > 0.0 or value_tol > 0.0
    scales = dict(zip(csp.CspParams._fields, csp.STEP_SCALES))
    p = params
    for t in range(iters):
        loss, g = value_and_grad(p)
        gsq = sum(torch.sum(gi * gi, tuple(range(len(lead_shape), gi.dim())))
                  for gi in g.values())
        gnorm = torch.sqrt(gsq + 1e-12)
        decay = 0.5 * (1 + math.cos(math.pi * t / iters))
        gate = 1.0 - done
        upd = {}
        for k in blocks:
            m[k] = 0.7 * m[k] + g[k] / csp._per_series(gnorm, g[k])
            upd[k] = (csp._per_series(gate, m[k])
                      * (lr * decay * scales[k]) * m[k])
        p = p._replace(**{k: getattr(p, k) + upd[k] for k in blocks})
        if use_tols:
            usq = sum(torch.sum(ui * ui,
                                tuple(range(len(lead_shape), ui.dim())))
                      for ui in upd.values())
            unorm = torch.sqrt(usq + 1e-18)
            stalled = torch.zeros_like(done, dtype=torch.bool)
            if t > 0:
                if value_tol > 0.0:
                    stalled = stalled | (loss - prev < value_tol)
                if step_tol > 0.0:
                    stalled = stalled | (unorm < step_tol)
            done = torch.maximum(done, stalled.to(done.dtype))
            prev = loss
    with torch.no_grad():
        s0 = loss_fn(params)
        s1 = loss_fn(p)
        better = s1 >= s0
        p_final = csp.CspParams(*(torch.where(csp._per_series(better, a), b, a)
                                  for a, b in zip(params, p)))
        return p_final, torch.where(better, s1, s0), p


def problem(seed=0, dev="cpu", S=S, T=T, P=P, box=BOX, pixel=PIXEL):
    """(params, xv, centres, defocus, mask points, Fref, tilt weights,
    validity) of S series: seeded noise windows, a start near a tilt
    scheme, every validity 1 but one particle of the first series."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.as_tensor(refine3d.make_mask_points(box, pixel, 40.0,
                                                     2.5 * pixel))
    G = mask.shape[0]
    vol = torch.randn((box,) * 3, generator=g)
    xv = torch.complex(torch.randn(S, T, P, G, generator=g),
                       torch.randn(S, T, P, G, generator=g))
    params = csp.CspParams(
        torch.linspace(-40, 40, T).repeat(S, 1) + torch.randn(S, T, generator=g),
        85.0 + torch.randn(S, T, generator=g),
        torch.randn(S, T, 2, generator=g),
        torch.rand(S, P, 3, generator=g) * 90,
        torch.randn(S, P, 3, generator=g) * 20,
        torch.randn(S, T, generator=g) * 50)
    centres = torch.randn(S, T, P, 2, generator=g) * 20
    df = torch.full((S, T, 2), 15000.0)
    valid = torch.ones(S, T, P)
    valid[0, :, -1] = 0.0
    out = (params, xv, centres, df, mask, fourier_slice.volume_to_fourier(vol),
           torch.ones(S, T), valid)
    return tuple(csp.CspParams(*(x.to(dev) for x in a))
                 if isinstance(a, csp.CspParams) else a.to(dev) for a in out)


def args_of(pr, mode, iters=4, lr=0.3, reg_weight=0.1, step_tol=0.0,
            value_tol=0.0, n=BOX, pixel=PIXEL):
    return (*pr, mode, n, pixel, iters, lr, reg_weight, KW["voltage_kv"],
            KW["cs_mm"], KW["amplitude_contrast"], step_tol, value_tol)


def buffers(pr, h):
    """The tensors `_refine_mode_xv` hands to the step loop."""
    with torch.no_grad():
        return csp._mode_buffers(*pr, h)


def steps_of(mode, iters=4, **kw):
    h = dict(mode=mode, n=BOX, pixel_size=PIXEL, iters=iters, lr=0.3,
             reg_weight=0.1, step_tol=0.0, value_tol=0.0, **KW)
    h.update(kw)
    return csp._Steps(**h)


def eager(b, h):
    """The refined blocks of `_mode_steps` on copies of b's tensors."""
    c = {k: v.clone() for k, v in b.items()}
    csp._mode_steps(c, h)
    return {k: c[k] for k in csp.MODE_BLOCKS[h.mode]}


class _Replay:
    def __init__(self, fn):
        self.fn, self.was_reset = fn, False

    def replay(self):
        self.fn()

    def reset(self):
        self.was_reset = True


class EagerGraphs(csp.ModeGraphs):
    """ModeGraphs whose "graph" replays by calling the captured function
    again: the cache's bookkeeping on the CPU."""

    def _capture(self, bufs, h, pool):
        self.last = _Replay(lambda: csp._mode_steps(bufs, h))
        return self.last, tuple((0, 0) for _ in csp._COUNTED)


def storages(ts):
    return {t.untyped_storage().data_ptr() for t in ts}


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", MODES + (4,))
@pytest.mark.parametrize("tols", [(0.0, 0.0), (0.05, 1e-3)])
def test_refine_mode_equals_the_old_loop(mode, tols):
    pr = problem(seed=mode)
    args = args_of(pr, mode, iters=5, step_tol=tols[0], value_tol=tols[1])
    new = csp._refine_mode_xv(*args)
    old_final, old_score, old_steps = old_refine_mode_xv(*args)
    for a, b in zip(new[0], old_final):
        assert torch.equal(a, b)
    assert torch.equal(new[1], old_score)
    h = steps_of(mode, iters=5, step_tol=tols[0], value_tol=tols[1])
    steps = eager(buffers(pr, h), h)
    for k, v in steps.items():
        assert torch.equal(v, getattr(old_steps, k)), k
        assert not torch.equal(v, getattr(pr[0], k)), k


def test_steps_write_the_state_back():
    h = steps_of(1, iters=3, step_tol=0.05, value_tol=1e-3)
    b = buffers(problem(), h)
    c = {k: v.clone() for k, v in b.items()}
    csp._mode_steps(c, h)
    assert not torch.equal(c["particle_eulers"], b["particle_eulers"])
    assert not torch.equal(c["m.particle_eulers"], b["m.particle_eulers"])
    assert torch.isfinite(c["prev"]).all()          # the last step's loss
    for k in ("xv", "Fref", "tilt_angles", "particle_pos"):
        assert torch.equal(c[k], b[k])              # inputs left as they were


@pytest.mark.parametrize("mode", MODES)
def test_replays_with_new_inputs_equal_fresh_calls(mode):
    graphs = EagerGraphs()
    h = steps_of(mode)
    b1, b2 = buffers(problem(seed=1), h), buffers(problem(seed=2), h)
    want1, want2 = eager(b1, h), eager(b2, h)
    kept = {k: v.clone() for k, v in b2.items()}
    same(graphs.run(h, b1), want1)
    same(graphs.run(h, b2), want2)
    same(graphs.run(h, b1), want1)
    same(b2, kept)                                  # the caller's tensors unchanged
    assert (graphs.captures, graphs.replays, len(graphs)) == (1, 3, 1)


def test_no_returned_tensor_shares_a_buffer():
    graphs = EagerGraphs()
    h = steps_of(0)
    b = buffers(problem(), h)
    first = graphs.run(h, b)
    again = graphs.run(h, b)
    bufs = storages(graphs._graphs[graphs.key(h, b)].bufs.values())
    for out in (first, again):
        assert not storages(out.values()) & bufs
        assert not storages(out.values()) & storages(b.values())


def test_the_key_separates_every_input():
    h = steps_of(3)
    b = buffers(problem(), h)
    key = csp.ModeGraphs.key(h, b)
    assert csp.ModeGraphs.key(h, dict(b)) == key
    others = [h._replace(**{f: v}) for f, v in (
        ("mode", 5), ("n", 32), ("pixel_size", 2.0), ("iters", 5),
        ("lr", 0.2), ("reg_weight", 0.2), ("voltage_kv", 200.0),
        ("cs_mm", 2.0), ("amplitude_contrast", 0.1), ("step_tol", 0.1),
        ("value_tol", 0.1))]
    keys = {csp.ModeGraphs.key(o, b) for o in others}
    assert len(keys) == len(others) and key not in keys
    for name in ("xv", "valid", "tilt_shifts", "Fref", "mask_pts", "u0"):
        x = b[name]
        for changed in (x[..., :-1], x.to(torch.float64 if not x.is_complex()
                                          else torch.complex128),
                        torch.empty(x.shape, dtype=x.dtype, device="meta"),
                        x.transpose(0, 1) if x.dim() > 1 else x[None]):
            assert csp.ModeGraphs.key(h, {**b, name: changed}) != key, name
    assert csp.ModeGraphs.key(h, {k: v for k, v in b.items() if k != "df0"}) != key


def test_the_cache_keeps_its_bound():
    graphs = EagerGraphs()
    pr = problem()
    shared = [steps_of(m, iters=1) for m in (3, 0)]         # one schedule
    own = [steps_of(3, iters=i) for i in range(2, csp._MAX_GRAPHS)]
    made = {}
    for h in shared + own:                          # each captured and replayed
        b = buffers(pr, h)
        graphs.run(h, b)
        made[h] = graphs.last
        graphs.run(h, b)
    assert len(graphs) == csp._MAX_GRAPHS == len(graphs._schedules) + 1
    graphs.run(shared[0], buffers(pr, shared[0]))   # now the most recent
    extra = steps_of(3, iters=20)
    graphs.run(extra, buffers(pr, extra))           # drops shared[1]'s graph
    assert len(graphs) == csp._MAX_GRAPHS
    assert made[shared[1]].was_reset and not made[shared[0]].was_reset
    assert graphs.key(shared[1], buffers(pr, shared[1])) not in graphs._graphs
    assert len(graphs._schedules) == csp._MAX_GRAPHS   # shared[0] keeps its buffers
    for h in own + [extra]:                         # shared[0] the least recent
        graphs.run(h, buffers(pr, h))
    last = steps_of(3, iters=21)
    graphs.run(last, buffers(pr, last))             # drops shared[0]'s graph
    assert made[shared[0]].was_reset
    assert len(graphs._schedules) == len(graphs) == csp._MAX_GRAPHS  # its buffers went
    assert graphs.captures == csp._MAX_GRAPHS + 2
    graphs.clear()
    assert len(graphs) == 0 and not graphs._schedules


def test_a_capture_waits_for_a_second_call_once_one_did_not_pay():
    graphs = EagerGraphs()
    pr = problem()
    h1, h2, h3 = (steps_of(1, iters=i) for i in (2, 3, 4))
    b1, b2, b3 = (buffers(pr, h) for h in (h1, h2, h3))
    same(graphs.run(h1, b1), eager(b1, h1))
    assert graphs.captures == 1                     # the first call captures
    graphs.clear()                                  # never replayed after it
    for _ in range(2):
        same(graphs.run(h2, b2), eager(b2, h2))     # eagerly, its first call
        assert (graphs.captures, len(graphs)) == (1, 0)
        graphs.clear()                              # forgets the call
    same(graphs.run(h2, b2), eager(b2, h2))
    same(graphs.run(h2, b2), eager(b2, h2))         # the second call captures
    assert (graphs.captures, graphs.replays) == (2, 2)
    same(graphs.run(h2, b2), eager(b2, h2))         # a replay: captures pay
    same(graphs.run(h3, b3), eager(b3, h3))
    assert (graphs.captures, graphs.replays, len(graphs)) == (3, 4, 2)


def test_zero_steps_capture_nothing():
    graphs = EagerGraphs()
    h = steps_of(2, iters=0)
    b = buffers(problem(), h)
    for _ in range(3):
        same(graphs.run(h, b), {k: b[k] for k in csp.MODE_BLOCKS[2]})
    assert (graphs.captures, graphs.replays, len(graphs._seen)) == (0, 0, 0)


def _in_threads(work, n=2):
    start, errors = threading.Barrier(n), []

    def body(i):
        start.wait()
        try:
            work(i)
        except Exception as e:     # noqa: BLE001 - reported by the caller
            errors.append((i, e))

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_threads_share_the_cache():
    graphs = EagerGraphs()
    h, other = steps_of(0), steps_of(1)
    bs = [buffers(problem(seed=s), h) for s in (5, 6)]
    bo = buffers(problem(seed=7), other)
    want = [eager(b, h) for b in bs]
    graphs.run(h, bs[0])                            # the main thread captures

    def work(i):
        for r in range(6):
            got = graphs.run(h, bs[i])
            assert all(torch.equal(got[k], want[i][k]) for k in want[i]), r
        # a key new to the cache: run eagerly, since this is not the main
        # thread
        same(graphs.run(other, bo), eager(bo, other))

    _in_threads(work)
    assert (graphs.captures, graphs.replays, len(graphs)) == (1, 13, 1)
    assert not graphs._seen


def test_schedule_graphs_share_buffers():
    graphs = EagerGraphs()
    pr = problem()
    got = {}
    for m in MODES:
        h = steps_of(m)
        got[m] = graphs.run(h, buffers(pr, h))
        same(got[m], eager(buffers(pr, h), h))
    bufs = [e.bufs for e in graphs._graphs.values()]
    assert all(b["xv"] is bufs[0]["xv"] for b in bufs)
    assert len(graphs._schedules) == 1


# --- on a card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_problem(seed):
    return problem(seed=seed, dev=_cuda(), S=2, T=41, P=32, box=32, pixel=4.0)


def _cuda_steps(mode):
    return steps_of(mode, iters=20, n=32, pixel_size=4.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_graph_equals_eager(mode):
    graphs = csp.ModeGraphs()
    h = _cuda_steps(mode)
    b1, b2 = buffers(_cuda_problem(1), h), buffers(_cuda_problem(2), h)
    want1, want2 = eager(b1, h), eager(b2, h)
    same(graphs.run(h, b1), want1)                  # capture, then replays
    same(graphs.run(h, b2), want2)
    same(graphs.run(h, b1), want1)
    torch.cuda.synchronize()
    assert (graphs.captures, graphs.replays) == (1, 3)
    graphs.clear()


def _kernels_run(fn, names):
    """How many times each kernel of `names` ran on the card during fn(),
    by the profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [sum(e.count for e in prof.key_averages() if name in e.key)
            for name in names]


@pytest.mark.cuda
@pytest.mark.parametrize("fn,names", [
    (kernels.csp_slice_gather, ("slice_gather_forward",
                                "slice_gather_backward")),
    (kernels.csp_score, ("score_forward", "score_backward"))])
def test_cuda_counters(fn, names):
    graphs = csp.ModeGraphs()
    h = _cuda_steps(1)                              # a gather in every step
    b = buffers(_cuda_problem(3), h)
    counts = []
    for _ in range(3):
        f0, b0 = fn.launches, fn.backward_launches
        graphs.run(h, b)
        counts.append((fn.launches - f0, fn.backward_launches - b0))
    # a forward and a backward each step of a replay, and of the first
    # call's two warm-up steps; the capture itself launches nothing
    assert counts == [(22, 22), (20, 20), (20, 20)]
    f0, b0 = fn.launches, fn.backward_launches
    ran = _kernels_run(lambda: graphs.run(h, b), names)
    assert ran == [fn.launches - f0, fn.backward_launches - b0] == [20, 20]
    assert (graphs.captures, graphs.replays) == (1, 4)
    graphs.clear()


@pytest.mark.cuda
def test_cuda_threads_share_the_cache():
    graphs = csp.ModeGraphs()
    h, other = _cuda_steps(0), _cuda_steps(1)
    bs = [buffers(_cuda_problem(s), h) for s in (5, 6)]
    bo = buffers(_cuda_problem(7), other)
    want = [eager(b, h) for b in bs]
    want_other = eager(bo, other)
    same(graphs.run(h, bs[0]), want[0])             # the main thread captures

    def work(i):
        for r in range(4):
            if i == 1:
                # eager work on the card beside the other thread's replays:
                # a key new to the cache (not captured off the main
                # thread), a new allocation, a synchronize
                same(graphs.run(other, bo), want_other)
                torch.empty((r + 1) << 26, dtype=torch.uint8, device="cuda")
                torch.cuda.synchronize()
            got = graphs.run(h, bs[i])
            torch.cuda.synchronize()
            assert all(torch.equal(got[k], want[i][k]) for k in want[i]), r

    _in_threads(work)
    assert (graphs.captures, graphs.replays, len(graphs)) == (1, 9, 1)
    graphs.clear()


class _EagerCache:
    def run(self, h, b):
        return eager(b, h)


@pytest.mark.cuda
def test_cuda_schedule_with_graphs_equals_eager(monkeypatch):
    pr = _cuda_problem(4)
    offsets, spin = csp.build_mode_offsets(MODES, None)

    def refine():
        return csp.csp_refine_batch(*pr, offsets, spin, MODES, 32, 4.0,
                                    iters_per_mode=20, series_vmap=True)

    csp.graph.clear()
    c0 = csp.graph.captures
    first, second = refine(), refine()
    assert csp.graph.captures - c0 == len(MODES)
    monkeypatch.setattr(csp, "graph", _EagerCache())
    plain = refine()
    for out in (first, second):
        for a, b in zip(out[0], plain[0]):
            assert torch.equal(a, b)
        assert torch.equal(out[1], plain[1]) and torch.equal(out[2], plain[2])
