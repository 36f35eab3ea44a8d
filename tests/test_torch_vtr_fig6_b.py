"""Algorithm 1 at Fig 6's two points for the last five VTR benchmarks:
the port against the reference on the CPU (``tests/test_torch_vtr_fig6.py``
holds the first five and says what each case checks)."""
import pytest

from test_torch_vtr_fig6 import NAMES, POINT_IDS, POINTS, hold_algorithm1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread beside the other test processes."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("t_amb,theta", POINTS, ids=POINT_IDS)
@pytest.mark.parametrize("name", NAMES[5:])
def test_algorithm1_equals_reference(name, t_amb, theta):
    hold_algorithm1(name, t_amb, theta)
