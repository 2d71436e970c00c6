"""The harness operator cases at batch ranks 1 and 2 (executor-level batch
lift): every dtype, every port backend, bit-exact against the JAX package
(see tests/test_torch_cases.py)."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_cases import _dtype_params, run_case  # noqa: E402


@pytest.mark.parametrize("case,dtype,batch_dims", _dtype_params((1, 2)))
def test_batched_case_matches_reference_package(case, dtype, batch_dims):
    run_case(case, dtype, batch_dims)
