"""The reader of the fit's resampling launches,
``metrics/fit.resample_launches_per_iter.py``, on synthetic spans: the
``fit`` spans' ``resamples`` over the window's subject-iterations, and
nothing to read where the program does not count them."""
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


@pytest.mark.parametrize("attrs, want", [
    (dict(resamples=250, stencils=130), 25.0),
    (dict(resamples=0, stencils=0), 0.0),
    (dict(stencils=130), None),  # a program that does not count them
])
def test_the_resample_reader_reads_the_fit_spans(attrs, want):
    record = _unit(attrs)
    assert recorder.units(record)
    read = spec.metric_reader("fit.resample_launches_per_iter")
    assert read(record) == want
