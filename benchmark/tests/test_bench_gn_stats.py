"""The reader of the rigid GN statistics' launches,
``metrics/fit.gn_stats_launches_per_iter.py``, on synthetic spans: the
``fit`` spans' ``gn_stats`` over the window's subject-iterations, and
nothing to read where the program does not count them (a tree older than
the kernel)."""
import pytest

from harness import recorder, spec


def _unit(fit_attrs, n_iter=(10,)):
    """A synthetic unit: a ``run.unit`` span holding a ``fit`` span with
    ``fit_attrs``, and the record's units that match it."""
    from unires_torch.utils import trace

    with trace.span("run.unit", B=1) as unit:
        with trace.span("fit", B=1, n_iter=list(n_iter), **fit_attrs):
            pass
    return dict(units=[dict(B=1, init_s=0.0, fit_s=unit.s,
                            n_iter=list(n_iter))],
                spans={}, profile=None, pairs=[], config={},
                device_kind="cpu", peaks={})


@pytest.mark.parametrize("attrs, n_iter, want", [
    (dict(gn_stats=54, blurs=1050, resamples=357), (10,), 5.4),
    (dict(gn_stats=114, blurs=820, resamples=400), (7, 13), 5.7),
    (dict(gn_stats=0, blurs=0, resamples=0), (10,), 0.0),
    (dict(blurs=1050, resamples=357, stencils=127), (10,), None),  # none
])
def test_the_gn_stats_reader_reads_the_fit_spans(attrs, n_iter, want):
    record = _unit(attrs, n_iter)
    assert recorder.units(record)
    read = spec.metric_reader("fit.gn_stats_launches_per_iter")
    assert read(record) == pytest.approx(want) if want is not None \
        else read(record) is None


def test_the_metric_is_declared_for_every_cell():
    """Every cell's fit runs the rigid round, so every cell reads it."""
    for name in ("sr3.subjects", "common.subjects", "sr3.batch2",
                 "denoise3.subjects"):
        assert "fit.gn_stats_launches_per_iter" in {
            m["name"] for m in spec.cell(name)["per_layer"]}
