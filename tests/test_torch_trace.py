"""The port's span recorder (``unires_torch.utils.trace``) on the CPU.

* Nesting, parents, subject ids, and one stack per host thread: ``fit_batch``
  on the CPU named twice drives each device's chunk on a thread of its own,
  its spans children of the batch's ``fit`` span.
* A span's interval against the profiler event it opens under an
  active profiler, on the profiler's clock: within 1 ms.
* One tiny ``preproc`` (co-registration, atlas alignment against a small
  atlas file, unified rigid and scaling) gives exactly the spans of the
  recorder's table, in their nesting; on the CPU nothing is captured, so no
  ``*.capture`` span.
* ``fit.chunk`` spans: one per chunk, whatever ``chunk_iters`` is; the
  ``fit`` span's ``n_iter`` is the one the fit returns and its ``syncs``
  the ``to_host.syncs`` delta.
* ``clear()`` and the bound on kept spans.
* An input array in Fortran order gives the same ``init`` as its C-ordered
  copy (``_read_image`` copies to C order for the kernels).
"""
import copy
import threading
import time

import numpy as np
import pytest
import torch

import unires_torch
from phantoms import blob_phantom, degrade
from unires_torch.parallel.fit_batch import fit_batch
from unires_torch.pipeline.fit import fit as t_fit
from unires_torch.pipeline.nifti import save
from unires_torch.utils import trace
from unires_torch.utils.host import to_host

torch.set_num_threads(2)

KW = dict(vx=1.0, do_coreg=False, do_print=0, max_iter=5, tolerance=0,
          write_out=False, device="cpu")
POSES = ([1.0, -0.5, 0.4, 0.02, -0.01, 0.015],
         [-0.8, 0.6, -0.3, -0.015, 0.01, -0.01])


@pytest.fixture(scope="module")
def chans():
    gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=5)
    out = []
    for ax, seed, rp in zip((2, 0), (11, 22), POSES):
        x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                            seed=seed, scl=0.1, rigid_params=rp)
        out.append([np.asarray(x), mat])
    return out


def _tree(spans, root):
    """(name, [children's trees]) of ``root`` over ``spans``, children in
    the order they opened."""
    kids = sorted((s for s in spans if s.parent == root.serial),
                  key=lambda s: s.serial)
    return (root.name, [_tree(spans, k) for k in kids])


def _below(spans, root):
    """Every span under ``root``."""
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        kids = [k for k in spans if k.parent == s.serial]
        out.extend(kids)
        todo.extend(kids)
    return out


def test_nesting_parents_and_ids():
    since = trace.serial()
    with trace.span("a", ids=(7,), n=1) as a:
        with trace.span("b") as b:
            with trace.span("c", ids=(8, 9)) as c:
                pass
        with trace.span("d") as d:
            d.attrs["m"] = 2
    with trace.span("e") as e:
        pass
    got = trace.spans(since=since)
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]  # as they end
    assert a.parent is None and e.parent is None
    assert b.parent == a.serial and d.parent == a.serial
    assert c.parent == b.serial
    assert a.serial < b.serial < c.serial < d.serial < e.serial
    assert (a.ids, b.ids, c.ids, d.ids, e.ids) == ((7,), (7,), (8, 9), (7,),
                                                   ())
    assert a.attrs == {"n": 1} and d.attrs == {"m": 2}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns \
        <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns
    assert all(s.thread == threading.get_ident() for s in got)
    assert not any(s.profiled for s in got)
    assert trace.spans("b", since) == [b]


def test_each_thread_has_its_own_stack():
    """Spans opened on a thread nest on that thread alone; ``within`` makes
    a thread's spans children of a span open on another."""
    since = trace.serial()
    seen = {}
    with trace.span("outer", ids=(1,)) as outer:
        def work(k):
            with trace.within(outer):
                with trace.span("worker", k=k) as w:
                    time.sleep(0.01)
                    with trace.span("inner"):
                        pass
            with trace.span("loose"):
                pass
            seen[k] = w
        threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    got = trace.spans(since=since)
    w0, w1 = seen[0], seen[1]
    assert w0.thread != w1.thread and outer.thread not in (w0.thread,
                                                           w1.thread)
    assert w0.parent == w1.parent == outer.serial
    assert w0.ids == w1.ids == (1,)
    for w in (w0, w1):
        inner = [s for s in got if s.name == "inner" and s.parent == w.serial]
        assert len(inner) == 1 and inner[0].thread == w.thread
    loose = [s for s in got if s.name == "loose"]
    assert len(loose) == 2 and all(s.parent is None for s in loose)


def test_fit_batch_threads_and_subject_ids(chans):
    """``fit_batch`` over the CPU named twice: one device thread per subject,
    whose chunks nest under the batch's ``fit`` span with that subject's
    id; ``init`` gave each subject its own id."""
    xs, ys, sett = [], [], None
    for k in range(2):
        data = copy.deepcopy(chans)
        data[0][0] = data[0][0] * (1.0 + 0.01 * k)
        x, y, sett = unires_torch.init(data, unires_torch.Settings(
            **dict(KW, max_iter=4, chunk_iters=2)))
        xs.append(x)
        ys.append(y)
    ids = trace.subjects(ys)
    assert len(set(ids)) == 2
    since = trace.serial()
    res = fit_batch(xs, ys, sett, devices=["cpu", "cpu"])
    got = trace.spans(since=since)
    fit, = [s for s in got if s.name == "fit"]
    assert fit.ids == ids and fit.attrs["B"] == 2
    assert fit.attrs["n_iter"] == [r[-1] for r in res] == [4, 4]
    chunks = [s for s in got if s.name == "fit.chunk"]
    assert len(chunks) == 4 and all(c.parent == fit.serial for c in chunks)
    threads = {c.thread for c in chunks}
    assert len(threads) == 2 and fit.thread not in threads
    for tid in threads:
        mine = [c for c in chunks if c.thread == tid]
        assert len(mine) == 2 and len({c.ids for c in mine}) == 1
        assert mine[0].ids[0] in ids
        for c in mine:
            kids = [s for s in got if s.parent == c.serial]
            assert [s.name for s in kids] == ["fit.chunk.launch",
                                              "fit.chunk.read"]
            assert all(s.thread == tid for s in kids)
    assert {c.ids for c in chunks} == {(i,) for i in ids}
    setups = [s for s in got if s.name == "fit.setup"]
    assert len(setups) == 2 and all(s.thread == fit.thread for s in setups)


def test_a_span_agrees_with_its_profiler_event():
    """Under an active profiler a span opens a host range of its name, an
    operator's range (no user annotation, which the profiler would also
    draw on the device's timeline); both intervals lie on the profiler's
    clock, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = []
        for k in range(3):
            with trace.span(f"probe.{k}") as s:
                torch.ones(1000).sum()
                time.sleep(0.004)
            spans.append(s)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("probe")}
    for s in spans:
        assert s.profiled
        e = events[s.name]
        assert not e.is_user_annotation
        assert abs(t0 + 1000 * e.time_range.start - s.start_ns) < 1e6
        assert abs(t0 + 1000 * e.time_range.end - s.end_ns) < 1e6
    assert abs(trace.now_ns() - time.time_ns()) < 1e6


def _table(levels_coreg, levels_atlas, chunks):
    """The spans of one ``preproc`` on the CPU (nothing captured)."""
    def level():
        return ("registration.level", [("registration.level.run", [])])

    def registration(name, levels):
        return (name, [("registration.pyramid", [])]
                + [level() for _ in range(levels)])

    chunk = ("fit.chunk", [("fit.chunk.launch", []), ("fit.chunk.read", [])])
    return ("run.unit", [
        ("init", [("init.read", []), ("init.hyperpar", []),
                  ("init.inputs", []),
                  registration("registration.coreg", levels_coreg),
                  registration("registration.atlas", levels_atlas),
                  ("init.grid", []), ("init.reslice", [])]),
        ("fit", [("fit.setup", [])] + [chunk] * chunks
         + [("fit.finish", [])]),
        ("run.output", [])])


def test_preproc_gives_the_table_of_spans(chans, tmp_path, monkeypatch):
    gt = blob_phantom(dim=(12, 12, 12), amplitude=1000.0, seed=3)
    atlas = str(tmp_path / "atlas.nii.gz")
    save(gt, atlas, affine=np.diag([2.0, 2.0, 2.0, 1.0]))
    monkeypatch.setenv("UNIRES_ATLAS", atlas)
    sett = unires_torch.Settings(**dict(
        KW, do_coreg=True, do_atlas_align=True, unified_rigid=True,
        scaling=True, max_iter=3, chunk_iters=2,
        coreg_params=dict(cost_fun="nmi", group="SE", samp=4, fwhm=7.0,
                          mean_space=False, levels=(8.0,))))
    since = trace.serial()
    unires_torch.preproc(copy.deepcopy(chans), sett)
    got = trace.spans(since=since)
    unit, = [s for s in got if s.name == "run.unit"]
    assert _tree(got, unit) == _table(2, 3, 2)
    assert unit.attrs["B"] == 1 and len(unit.ids) == 1
    assert all(s.ids == unit.ids for s in _below(got, unit))
    assert len(got) == len(_below(got, unit)) + 1
    named = {s.name: s for s in got}
    assert named["registration.coreg"].attrs == {"movers": 1}
    assert named["registration.atlas"].attrs == {"movers": 1}
    levels = [s.attrs for s in got if s.name == "registration.level"]
    assert [lv["mm"] for lv in levels] == [8.0, 4.0, 8.0, 4.0, 2.0]
    assert [lv["group"] for lv in levels] == ["SE"] * 2 + ["CSO"] * 3
    for lv in levels:
        assert set(lv) == {"mm", "group", "grid", "movers", "evals", "turns",
                           "captured", "nodes", "syncs"}
        assert lv["syncs"] == 2 * lv["turns"] + 2
    assert named["fit"].attrs["n_iter"] == [3]
    chunks = sorted((s for s in got if s.name == "fit.chunk"),
                    key=lambda s: s.serial)
    assert [c.attrs for c in chunks] == [
        dict(asked=2, iters=2, n_iter=[2]), dict(asked=1, iters=1,
                                                 n_iter=[3])]


@pytest.mark.parametrize("chunk_iters", [1, 2, 3, 5, 16])
def test_one_chunk_span_a_chunk(chans, chunk_iters):
    """``fit.chunk`` spans are the chunks (no span per iteration); the
    ``fit`` span's ``n_iter`` is the fit's and its ``syncs`` the reads."""
    x, y, sett = unires_torch.init(copy.deepcopy(chans), unires_torch.Settings(
        **dict(KW, chunk_iters=chunk_iters)))
    since, s0 = trace.serial(), to_host.syncs
    _, _, _, _, n_iter = t_fit(x, y, sett)
    syncs = to_host.syncs - s0
    got = trace.spans(since=since)
    fit, = [s for s in got if s.name == "fit"]
    chunks = [s for s in got if s.name == "fit.chunk"]
    assert len(chunks) == -(-KW["max_iter"] // min(chunk_iters,
                                                  KW["max_iter"]))
    assert sum(c.attrs["iters"] for c in chunks) == n_iter == 5
    assert fit.attrs["n_iter"] == [n_iter]
    assert fit.attrs["syncs"] == syncs > 0
    assert fit.attrs["stencils"] == 0  # the plain chain on the CPU
    assert fit.attrs["blurs"] == 0
    assert fit.ids == (trace.subject(y),)


def test_clear_and_the_bound():
    with trace.span("kept"):
        pass
    assert trace.spans("kept")
    trace.clear()
    assert trace.spans() == []
    first = trace.serial()
    for _ in range(trace.MAX_SPANS + 10):
        with trace.span("many"):
            pass
    got = trace.spans()
    assert len(got) == trace.MAX_SPANS
    # the oldest went first
    assert got[0].serial > first + 10 and got[-1].serial > got[0].serial
    trace.clear()
    assert trace.spans() == []


def test_fortran_ordered_input_gives_the_same_init(chans):
    data_c = copy.deepcopy(chans)
    data_f = [[np.asfortranarray(x), mat] for x, mat in data_c]
    assert not data_f[0][0].flags.c_contiguous
    sett = dict(KW, do_coreg=True, coreg_params=dict(
        cost_fun="nmi", group="SE", samp=4, fwhm=7.0, mean_space=False,
        levels=(8.0,)))
    xc, yc, sc = unires_torch.init(data_c, unires_torch.Settings(**sett))
    xf, yf, sf = unires_torch.init(data_f, unires_torch.Settings(**sett))
    for a, b in zip(yc, yf):
        assert torch.equal(a.dat, b.dat)
    for a, b in zip((o for c in xc for o in c), (o for c in xf for o in c)):
        assert a.dat.is_contiguous() and b.dat.is_contiguous()
        assert torch.equal(a.dat, b.dat) and a.tau == b.tau
    np.testing.assert_array_equal(sc.mat_coreg, sf.mat_coreg)


@pytest.mark.parametrize("form", ["fit", "batch"])
def test_a_registered_launch_group_reaches_the_fit_span(chans, form,
                                                        monkeypatch):
    """A kernel wrapped as ``Counted(fn, group=...)`` is counted in the
    ``fit`` span of a single fit and of a batch with no edit to
    ``pipeline/fit.py`` or ``parallel/fit_batch.py``, beside the stencils,
    resamples, blurs and GN statistics; the registry is as it was
    afterwards. The stand-in
    kernel counts its own launches in a CPU tensor, as a kernel does on the
    device, once an iteration."""
    from unires_torch.ops import cuda_build
    from unires_torch.solvers.fitloop import FitChunk

    before = {k: list(v) for k, v in cuda_build.GROUPS.items()}
    x, y, sett = unires_torch.init(copy.deepcopy(chans), unires_torch.Settings(
        **dict(KW, chunk_iters=2)))
    with monkeypatch.context() as m:
        m.setitem(cuda_build.GROUPS, "probes", [])
        probe = cuda_build.Counted(lambda: probe.count._dev[0][0].add_(1),
                                   group="probes")
        probe.count._dev[0] = torch.zeros(2, dtype=torch.int64)
        iterate = FitChunk.iterate

        def launching(self, *args, **kw):
            probe()
            return iterate(self, *args, **kw)

        m.setattr(FitChunk, "iterate", launching)
        since = trace.serial()
        n_iter = (t_fit(x, y, sett) if form == "fit"
                  else fit_batch([x], [y], sett)[0])[-1]
        fit, = trace.spans("fit", since)
    assert n_iter == 5 and fit.attrs["probes"] == 5 == probe.launches
    assert {"stencils", "resamples", "blurs", "gn_stats"} <= set(fit.attrs)
    assert {k: list(v) for k, v in cuda_build.GROUPS.items()} == before


@pytest.mark.parametrize("first_before_mark", [True, False])
def test_launches_since_sums_each_group_from_one_read(first_before_mark,
                                                      monkeypatch):
    """``cuda_build.launches_since`` over named groups of counted kernels:
    each group's launches since ``launch_marks``, a kernel first launched
    after the mark counted from 0, and all of them from one read of the
    device (one ``tolist``). The device counters stand in as CPU tensors."""
    from unires_torch.ops import cuda_build

    fns = [cuda_build.Counted(lambda: None) for _ in range(3)]
    groups = {"a": fns[:2], "b": fns[2:]}
    for f, n in zip(fns, (5, 7, 11)):
        if first_before_mark or f is not fns[1]:
            f.count._dev[0] = torch.tensor([n, 0])
    marks = cuda_build.launch_marks(groups)
    for f, n in zip(fns, (3, 4, 2)):
        t = f.count._dev.setdefault(0, torch.zeros(2, dtype=torch.int64))
        t[0] += n
    reads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: reads.append(1) or tolist(self))
    assert cuda_build.launches_since(groups, marks) == {"a": 7, "b": 2}
    assert len(reads) == 1
    assert cuda_build.launches_since(
        {"a": fns[:2]}, cuda_build.launch_marks({"a": fns[:2]})) == {"a": 0}
    assert cuda_build.launches_since({}, {}) == {}
