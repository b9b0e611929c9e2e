"""The EOT views' first objective and gradient on the float32 round trips
("slab", "frames", "ola", "fft"), against the JAX package's on the same
flags; the views, clips and bounds are tests/test_torch_eot_objective.py's,
which says why each bound is what it is."""

import pytest
import torch

from test_torch_eot_objective import check_path, make_jax_params, make_net


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the tier-1 run shares the cores among its xdist workers; torch's own
    # thread pool on top of that oversubscribes them many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", ["slab", "frames", "ola", "fft"])
def test_first_objective_and_gradient_with_views_match_jax(path):
    check_path(make_net(), make_jax_params(), path)
