"""The reader of the blur's launches,
``metrics/fit.blur_launches_per_iter.py``, on synthetic spans: the ``fit`` spans' ``blurs`` over the window's
subject-iterations, and nothing to read where the program does not count
them (a tree older than the blur kernels)."""
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
    (dict(blurs=1050, resamples=357, stencils=127), (10,), 105.0),
    (dict(blurs=820, resamples=400, stencils=130), (7, 13), 41.0),
    (dict(blurs=0, resamples=0, stencils=0), (10,), 0.0),
    (dict(resamples=357, stencils=127), (10,), None),  # no blur count
])
def test_the_blur_reader_reads_the_fit_spans(attrs, n_iter, want):
    record = _unit(attrs, n_iter)
    assert recorder.units(record)
    read = spec.metric_reader("fit.blur_launches_per_iter")
    assert read(record) == want


def test_the_metric_is_declared_for_the_super_resolution_cells():
    """Declared for the cells whose fit runs the blur, not for the
    denoising cell, which has none."""
    for name in ("sr3.subjects", "common.subjects", "sr3.batch2"):
        assert "fit.blur_launches_per_iter" in {
            m["name"] for m in spec.cell(name)["per_layer"]}
    assert "fit.blur_launches_per_iter" not in {
        m["name"] for m in spec.cell("denoise3.subjects")["per_layer"]}
