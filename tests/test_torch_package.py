"""The port's package surface against the JAX package's: ``__version__``
and the extension ``Protocol``s of ``interfaces.py`` (their names, their
members and each member's signature)."""

import inspect

import pytest

import aware_tpu
import aware_tpu.interfaces as jif
import aware_tpu_torch
import aware_tpu_torch.interfaces as tif

PROTOCOLS = ["AudioProcessor", "LossFn", "Metric", "PatternProcessor", "Embedder", "Detector",
             "AttackFn"]


def test_version_equals_the_jax_package():
    assert aware_tpu_torch.__version__ == aware_tpu.__version__ == "0.1.0"
    assert "__version__" in aware_tpu_torch.__all__


def test_the_same_protocols():
    def names(mod):
        return sorted(n for n, v in vars(mod).items()
                      if inspect.isclass(v) and getattr(v, "_is_protocol", False)
                      and v.__module__ == mod.__name__)

    assert names(tif) == names(jif) == sorted(PROTOCOLS)


@pytest.mark.parametrize("name", PROTOCOLS)
def test_protocol_members_and_signatures(name):
    ours, ref = getattr(tif, name), getattr(jif, name)
    assert ours.__protocol_attrs__ == ref.__protocol_attrs__
    for member in ref.__protocol_attrs__:
        theirs = getattr(ref, member, None)
        if callable(theirs):
            assert str(inspect.signature(getattr(ours, member))) == str(inspect.signature(theirs))
    assert ours.__annotations__ == ref.__annotations__


def test_protocols_check_structurally():
    class Det:
        def detect(self, audio, sample_rate):
            return audio

    assert isinstance(Det(), tif.Detector) and not isinstance(Det(), tif.Embedder)
    assert isinstance(lambda x: x, tif.AudioProcessor)
