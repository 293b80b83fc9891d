"""B2, the ``fused_zlane`` kernel on nr_2_0_4 Z=24: its plain PyTorch
version against ``make_fused_minsum_zlane(..., interpret=True)`` for the
layered min-sum schedule and both sum-product schedules (flooding min-sum is
in test_torch_zlane.py).  Min-sum: identical; sum-product: bits agree on
>= 99.9%, conv_iter within 1."""
import pytest

from test_torch_parity import EARLY_EXIT, THROUGHPUT, TRACKING, check_kernel_plain_against_jax


@pytest.mark.parametrize("mode,schedule,flags", [
    ("minsum", "layered", TRACKING),
    ("sumproduct", "flooding", THROUGHPUT),
    ("sumproduct", "layered", EARLY_EXIT),
])
def test_plain_matches_jax_kernel_nr_2_0_4(mode, schedule, flags):
    check_kernel_plain_against_jax("fused_zlane", "nr_2_0_4", 24, mode, schedule, *flags)
