"""The import guard compares whole top-level module names."""
from bench.lib import guard


def test_rejects_jax_and_the_jax_package():
    assert guard.forbidden_loaded({"jax.numpy": 1, "os": 1}) == ["jax"]
    assert guard.forbidden_loaded({"repro": 1, "repro.core.x": 1}) \
        == ["repro"]
    assert guard.forbidden_loaded({"jaxlib": 1, "flax.linen": 1}) \
        == ["flax", "jaxlib"]


def test_accepts_the_port():
    assert guard.forbidden_loaded({"repro_torch": 1,
                                   "repro_torch.kernels.build": 1,
                                   "reprolib": 1, "jax_like": 1}) == []
