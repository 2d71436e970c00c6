"""Every harness operator case through the port's executor backends on the
CPU (kernels' plain versions) against the JAX package, at batch rank 0:
bit-exact outputs (``resize`` within its stated atol), and the same
lowering paths (``pallas.`` -> ``cuda.``) and segment counts as the JAX
package's ``pallas`` backend, at batch ranks 0-2.

Outputs are compared against the JAX package's ``reference`` backend, which
tests/test_differential.py holds equal to its ``pallas`` backend; one
``pallas`` run per case and batch rank gives the lowering report."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.executor import TMExecutor as JExecutor  # noqa: E402
from repro_torch.core.executor import TMExecutor as TExecutor  # noqa: E402
from repro_torch.core.instr import TMProgram as TProgram  # noqa: E402
from tests.harness import ALL_DTYPES, CASES, make_inputs  # noqa: E402
from tests.test_torch_support import assert_same, to_torch  # noqa: E402

PORT_BACKENDS = ("reference", "fused", "cuda", "cuda+chains")


def _executor(backend: str) -> TExecutor:
    if backend == "cuda+chains":
        return TExecutor(backend="cuda", device="cpu", fuse_chains=True)
    return TExecutor(backend=backend, device="cpu")


def run_case(case, dtype: str, batch_dims: int) -> None:
    prog, shapes = case.build()
    tprog = TProgram.decode(prog.encode())
    bufs = make_inputs(case, shapes, dtype, batch_dims,
                       np.random.RandomState(1234))
    ref = JExecutor(backend="reference")(prog, bufs, batch_dims=batch_dims)
    tbufs = {k: to_torch(v) for k, v in bufs.items()}
    atol = 0.0 if case.exact else case.atol
    for backend in PORT_BACKENDS:
        got = _executor(backend)(tprog, tbufs, batch_dims=batch_dims)
        assert set(got) == set(ref)
        for k in ref:
            assert str(got[k].dtype) == f"torch.{ref[k].dtype}"
            assert_same(ref[k], got[k], atol=atol,
                        what=f"{case.name}/{dtype}/{backend}/{k}")


def _dtype_params(batch_ranks):
    return [pytest.param(c, d, b, id=f"{c.name}-{d}-b{b}")
            for c in CASES for b in batch_ranks
            if b == 0 or c.supports_batch for d in c.dtypes]


@pytest.mark.parametrize("case,dtype,batch_dims", _dtype_params((0,)))
def test_case_matches_reference_package(case, dtype, batch_dims):
    run_case(case, dtype, batch_dims)


@pytest.mark.parametrize(
    "case,batch_dims",
    [pytest.param(c, b, id=f"{c.name}-b{b}") for c in CASES
     for b in (0, 1, 2) if b == 0 or c.supports_batch])
def test_lowering_matches_reference_package(case, batch_dims):
    prog, shapes = case.build()
    dtype = "float32" if "float32" in case.dtypes else case.dtypes[-1]
    bufs = make_inputs(case, shapes, dtype, batch_dims,
                       np.random.RandomState(0))
    jex = JExecutor(backend="pallas")
    jex(prog, bufs, batch_dims=batch_dims)
    tex = TExecutor(backend="cuda", device="cpu")
    tex(TProgram.decode(prog.encode()), {k: to_torch(v)
                                         for k, v in bufs.items()},
        batch_dims=batch_dims)
    jrecs, trecs = jex.last_lowering.records, tex.last_lowering.records
    assert [r.path.replace("pallas.", "cuda.", 1) for r in jrecs] == \
        [r.path for r in trecs]
    assert [r.segments for r in jrecs] == [r.segments for r in trecs]
    assert [r.launches for r in jrecs] == [r.launches for r in trecs]
    assert all(r.is_kernel == r.path.startswith("cuda.") for r in trecs)


def test_every_dtype_covered():
    assert set(ALL_DTYPES) == {"int8", "int32", "bfloat16", "float32"}
