"""The port's kernel-dispatch registry against the reference package's:
bucket policy, backend resolution, pad/unpad round trips for both ops,
the dim-mismatch error, launch counting, and the O(log) launch-shape
bound over a real UTS run (mirrors tests/test_dispatch.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dispatch import bucket as jax_bucket
from repro.kernels.dispatch import get_kernel as jax_get_kernel
from repro.kernels.mandelbrot.ref import coords as jax_coords
from repro.kernels.mandelbrot.ref import mandelbrot_ref as jax_mandelbrot_ref
from repro.kernels.uts_hash.ref import uts_child_digests_ref as jax_sha1
from repro_torch.kernels.dispatch import (KernelOp, bucket, compile_log,
                                          dispatch, estimate_cost,
                                          get_kernel, launches,
                                          record_launch, register_kernel,
                                          registered_kernels,
                                          reset_compile_log, reset_launches,
                                          resolve_backend)
from repro_torch.kernels.mandelbrot.ops import mandelbrot
from repro_torch.kernels.mandelbrot.ref import mandelbrot_ref
from repro_torch.kernels.uts_hash.ops import uts_child_digests
from repro_torch.kernels.uts_hash.ref import uts_child_digests_ref

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it (the 256x256 dwell test goes from 1 s to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


# -- registry ------------------------------------------------------------------

def test_both_kernels_registered():
    assert {"uts_hash", "mandelbrot"} <= set(registered_kernels())


def test_get_kernel_unknown_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        get_kernel("does_not_exist")


def test_resolve_backend():
    assert resolve_backend(None, CPU) == "ref"
    assert resolve_backend(None, torch.device("cuda")) == "cuda"
    assert resolve_backend("ref", CPU) == "ref"
    assert resolve_backend("ref", torch.device("cuda")) == "ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resolve_backend("cuda", CPU)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("tpu-pallas", CPU)


def test_bucket_policy():
    assert bucket(0) == 128 and bucket(1) == 128 and bucket(128) == 128
    assert bucket(129) == 256 and bucket(1000) == 1024
    assert bucket(5, floor=8) == 8 and bucket(9, floor=8) == 16
    with pytest.raises(ValueError):
        bucket(4, floor=0)


@pytest.mark.parametrize("floor", [1, 8, 128, 4096])
def test_bucket_matches_reference(floor):
    for n in list(range(0, 300)) + [4095, 4096, 4097, 10**6]:
        assert bucket(n, floor) == jax_bucket(n, floor)


def test_floors_and_pads_match_reference():
    for name in ("uts_hash", "mandelbrot"):
        mine, ref = get_kernel(name), jax_get_kernel(name)
        assert mine.bucket_floor == ref.bucket_floor
        assert mine.pad_values == ref.pad_values
        assert mine.arg_dims == ref.arg_dims
        assert mine.out_dims == ref.out_dims


def test_estimate_cost_uses_unpadded_operands():
    par = torch.zeros((5, 37), dtype=torch.int32)
    assert estimate_cost("uts_hash", par, torch.zeros(37, dtype=torch.int32)) \
        == 37.0


def test_dim_mismatch_raises():
    par = torch.zeros((5, 8), dtype=torch.int32)
    ix = torch.zeros((9,), dtype=torch.int32)  # shared dim "n" disagrees
    with pytest.raises(ValueError, match="dim 'n'"):
        dispatch("uts_hash", par, ix, backend="ref")


def test_cuda_backend_on_cpu_tensors_raises():
    par = torch.zeros((5, 8), dtype=torch.int32)
    ix = torch.zeros((8,), dtype=torch.int32)
    reset_launches("uts_hash")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        uts_child_digests(par, ix, backend="cuda")
    assert launches("uts_hash") == 0


def test_launch_counter():
    reset_launches("_test_counter")
    assert launches("_test_counter") == 0
    for _ in range(3):
        record_launch("_test_counter")
    assert launches("_test_counter") == 3
    reset_launches("_test_counter")
    assert launches("_test_counter") == 0


def test_cpu_dispatch_launches_no_kernel():
    reset_launches()
    rng = np.random.RandomState(0)
    uts_child_digests(_i32(rng.randint(0, 2**31, size=(5, 10))
                           .astype(np.uint32)),
                      torch.arange(10, dtype=torch.int32))
    mandelbrot(torch.zeros((3, 3)), torch.zeros((3, 3)), 4)
    assert launches("uts_hash") == 0 and launches("mandelbrot") == 0


# -- pad/unpad round-trips ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 37, 127, 128, 129, 300])
def test_uts_hash_round_trip_exact(n):
    """dispatch pads to the bucket and slices back: bit-identical to the
    plain body on the unpadded operands and to the reference package."""
    rng = np.random.RandomState(n)
    par = rng.randint(0, 2**31, size=(5, n)).astype(np.uint32)
    ix = rng.randint(0, 2**16, size=(n,)).astype(np.uint32)
    want = np.asarray(jax_sha1(jnp.asarray(par), jnp.asarray(ix)))
    got = uts_child_digests(_i32(par), _i32(ix), backend="ref")
    assert got.shape == (5, n)
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(uts_child_digests_ref(_i32(par), _i32(ix))),
                          want)


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 17), (8, 64)])
def test_mandelbrot_round_trip_exact(shape):
    cre, cim = (np.asarray(a) for a in jax_coords(-2.0, -1.5, 1.0, 1.5,
                                                   *shape))
    want = np.asarray(jax_mandelbrot_ref(jnp.asarray(cre), jnp.asarray(cim),
                                         24))
    got = mandelbrot(torch.from_numpy(cre.copy()), torch.from_numpy(cim.copy()),
                     24, backend="ref")
    assert got.shape == shape and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        mandelbrot_ref(torch.from_numpy(cre.copy()),
                       torch.from_numpy(cim.copy()), 24).numpy(), want)


# -- launch-shape bounds ---------------------------------------------------------

def _uts_frontier_sizes(max_depth: int):
    """Generation-by-generation frontier sizes of a real UTS run."""
    from repro_torch.algorithms.uts import (Bag, UTSParams,
                                            _expand_generation)
    params = UTSParams(seed=19, b0=4.0, max_depth=max_depth, chunk=4096)
    bag = Bag.root(params, CPU)
    sizes = []
    while bag.size:
        sizes.append(bag.size)
        bag = Bag(*_expand_generation(bag.digests, bag.depths, params))
    return sizes


def test_compile_log_bounded_over_uts_run():
    """Frontier sizes vary every generation, yet bucketing keeps distinct
    launch shapes O(log max_frontier)."""
    sizes = _uts_frontier_sizes(max_depth=7)
    assert len(set(sizes)) > 5
    reset_compile_log("uts_hash")
    rng = np.random.RandomState(0)
    for n in sizes:
        par = _i32(rng.randint(0, 2**31, size=(5, n)).astype(np.uint32))
        ix = torch.from_numpy(rng.randint(0, 64, size=(n,)).astype(np.int32))
        uts_child_digests(par, ix, backend="ref")
    entries = compile_log("uts_hash")["uts_hash"]
    bound = int(math.log2(bucket(max(sizes)) / 128)) + 1
    assert len(entries) <= bound
    assert len(entries) < len(set(sizes))


def test_mandelbrot_compile_log_bounded():
    reset_compile_log("mandelbrot")
    for h, w in [(3, 5), (4, 9), (7, 7), (8, 8), (13, 30), (16, 31)]:
        cre = torch.zeros((h, w))
        mandelbrot(cre, cre.clone(), 8, backend="ref")
    # 6 distinct sizes collapse onto {8,16}x{8,16,32} buckets max
    assert len(compile_log("mandelbrot")["mandelbrot"]) <= 4


# -- registering a new op --------------------------------------------------------

def test_register_new_kernel_and_dispatch():
    seen_shapes = []

    def body(x, *, scale):
        seen_shapes.append(tuple(x.shape))
        return x * scale

    register_kernel(KernelOp(
        name="_test_double",
        cuda_body=lambda x, *, scale: x * scale,
        reference_body=body,
        arg_dims=(((0, "n"),),),
        pad_values=(0,),
        out_dims=((0, "n"),),
        bucket_floor=4,
        cost_hint=lambda x: float(x.shape[0]),
    ))
    out = dispatch("_test_double", torch.arange(5.0), scale=2.0)
    assert out.shape == (5,)
    np.testing.assert_array_equal(out.numpy(), 2.0 * np.arange(5.0))
    assert seen_shapes == [(8,)]        # padded to the next bucket
