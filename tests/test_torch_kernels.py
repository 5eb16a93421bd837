"""The port's plain kernel versions against the reference package: the
PyTorch SHA-1 against hashlib, the numpy implementation and the JAX
``ref`` backend; the threshold-table child counts against
``geometric_children_np``; the PyTorch dwell against the JAX ``ref``
dwell.  Every comparison is bit-exact.  The two tests marked ``cuda``
hold the hand kernels against the plain versions and need the card."""
import hashlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mandelbrot.ops import mandelbrot as jax_mandelbrot
from repro.kernels.mandelbrot.ref import coords as jax_coords
from repro.kernels.uts_hash.numpy_impl import (geometric_children_np,
                                               uts_child_digests_np)
from repro.kernels.uts_hash.ops import root_digest as jax_root_digest
from repro.kernels.uts_hash.ops import uts_child_digests as jax_digests
from repro_torch.kernels import _build
from repro_torch.kernels.mandelbrot.ops import mandelbrot, mandelbrot_cuda
from repro_torch.kernels.mandelbrot.ref import (_fma_f32, coords,
                                                mandelbrot_ref)
from repro_torch.kernels.uts_hash.ops import uts_child_digests, uts_hash_cuda
from repro_torch.kernels.uts_hash.ref import (child_count_thresholds,
                                              geometric_children,
                                              root_digest,
                                              uts_child_digests_ref)

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
    return t.contiguous().cpu().numpy().view(np.uint32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


# -- uts_hash -------------------------------------------------------------------

def _hashlib_oracle(parents, ixs):
    n = parents.shape[1]
    out = np.zeros((5, n), np.uint32)
    for j in range(n):
        msg = b"".join(int(parents[i, j]).to_bytes(4, "big")
                       for i in range(5)) + int(ixs[j]).to_bytes(4, "big")
        dig = hashlib.sha1(msg).digest()
        for i in range(5):
            out[i, j] = int.from_bytes(dig[4 * i:4 * i + 4], "big")
    return out


@pytest.mark.parametrize("n", [1, 2, 127, 128, 200])
def test_sha1_matches_hashlib_numpy_and_jax(n):
    rng = np.random.RandomState(n)
    parents = rng.randint(0, 2**32, size=(5, n), dtype=np.uint64) \
        .astype(np.uint32)
    ixs = rng.randint(0, 2**32, size=(n,), dtype=np.uint64).astype(np.uint32)
    oracle = _hashlib_oracle(parents, ixs)
    got = _u32(uts_child_digests_ref(_i32(parents), _i32(ixs)))
    assert np.array_equal(got, oracle)
    assert np.array_equal(got, uts_child_digests_np(parents, ixs))
    jax_ref = np.asarray(jax_digests(jnp.asarray(parents), jnp.asarray(ixs),
                                     backend="ref"))
    assert np.array_equal(got, jax_ref)
    assert np.array_equal(_u32(uts_child_digests(_i32(parents), _i32(ixs))),
                          oracle)


@pytest.mark.parametrize("seed", [0, 19, 42, 2**31 + 5, 2**32 - 1])
def test_root_digest_matches_jax(seed):
    got = _u32(root_digest(seed, CPU))
    assert got.shape == (5, 1)
    assert np.array_equal(got, np.asarray(jax_root_digest(seed)))


def _digests_with_u31(u31: np.ndarray) -> np.ndarray:
    """[5, n] uint32 digests whose first word carries ``u31`` (and a random
    low bit), so random_u31 recovers it."""
    rng = np.random.RandomState(len(u31))
    d = rng.randint(0, 2**32, size=(5, len(u31)), dtype=np.uint64) \
        .astype(np.uint32)
    d[0] = (u31.astype(np.uint32) << np.uint32(1)) | (d[0] & np.uint32(1))
    return d


@pytest.mark.parametrize("b0", [4.0, 2.0])
def test_child_counts_at_every_table_boundary(b0):
    table = child_count_thresholds(b0, 64).astype(np.int64)
    assert len(table) == 64 and np.all(np.diff(table) >= 0)
    u31 = np.unique(np.clip(
        (table[:, None] + np.arange(-2, 3)[None, :]).ravel(), 0, 2**31 - 1))
    u31 = np.concatenate([u31, [0, 1, 2**31 - 2, 2**31 - 1]])
    dig = _digests_with_u31(u31)
    depth = np.zeros(len(u31), np.int32)
    want = geometric_children_np(dig, depth, b0=b0)
    got = geometric_children(_i32(dig), torch.from_numpy(depth), b0=b0)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_child_counts_on_a_million_u31_values():
    rng = np.random.RandomState(2024)
    u31 = rng.randint(0, 2**31, size=10**6).astype(np.int64)
    dig = _digests_with_u31(u31)
    depth = rng.randint(0, 20, size=10**6).astype(np.int32)
    want = geometric_children_np(dig, depth, b0=4.0, max_depth=18)
    got = geometric_children(_i32(dig), torch.from_numpy(depth), b0=4.0,
                             max_depth=18)
    assert np.array_equal(got.numpy(), want)


def test_uts_hash_cuda_wrapper_rejects_cpu_tensors():
    par = torch.zeros((5, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        uts_hash_cuda(par, torch.zeros(4, dtype=torch.int32))


# -- mandelbrot -----------------------------------------------------------------

def _planes(shape):
    cre, cim = jax_coords(-2.0, -1.5, 1.0, 1.5, *shape)
    return np.asarray(cre), np.asarray(cim)


@pytest.mark.parametrize("shape", [(8, 8), (16, 64), (33, 17), (1, 100)])
@pytest.mark.parametrize("max_iter", [1, 13, 64])
def test_dwell_matches_jax_ref(shape, max_iter):
    cre, cim = _planes(shape)
    want = np.asarray(jax_mandelbrot(jnp.asarray(cre), jnp.asarray(cim),
                                     max_iter, backend="ref"))
    got = mandelbrot(torch.from_numpy(cre.copy()),
                     torch.from_numpy(cim.copy()), max_iter)
    assert np.array_equal(got.numpy(), want)


def test_dwell_matches_jax_ref_256_plane_at_512():
    """The plane on which only the fused new_im reproduces XLA's rounding."""
    cre, cim = _planes((256, 256))
    want = np.asarray(jax_mandelbrot(jnp.asarray(cre), jnp.asarray(cim), 512,
                                     backend="ref"))
    got = mandelbrot_ref(torch.from_numpy(cre.copy()),
                         torch.from_numpy(cim.copy()), 512)
    assert np.array_equal(got.numpy(), want)


def test_dwell_known_points():
    # c=0 is in the set; c=1 escapes at iteration 3 (z:0,1,2,5...)
    img = mandelbrot(torch.tensor([[0.0, 1.0]]), torch.tensor([[0.0, 0.0]]),
                     50)
    assert int(img[0, 0]) == 50
    assert int(img[0, 1]) == 3


def test_coords_dwell_shapes():
    c_re, c_im = coords(-2, -1.5, 1, 1.5, 37, 53, device="cpu")
    assert c_re.shape == c_im.shape == (37, 53)
    assert float(c_re[0, 0]) == -2.0 and float(c_re[0, -1]) == 1.0
    assert float(c_im[0, 0]) == -1.5 and float(c_im[-1, 0]) == 1.5
    img = mandelbrot(c_re, c_im, 16)
    assert img.shape == (37, 53)
    assert img.dtype == torch.int32
    assert int(img.max()) <= 16 and int(img.min()) >= 0


def _round_f32(x: Fraction) -> np.float32:
    """Correctly rounded (ties to even) float32 of an exact rational."""
    r = np.float32(float(x))
    best = None
    for c in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        key = (d, int(np.array(c).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, c)
    return best[1]


def test_fma_is_single_rounding():
    """_fma_f32 against exact rational arithmetic, including a case where
    rounding a*b+c to float64 first lands on a float32 tie (double
    rounding would give the wrong neighbour)."""
    f = np.float32
    a = [f(1 + 2**-23) * f(2**-12)]
    b = [f(1 - 2**-23) * f(2**-12)]
    c = [f(1 + 2**-23)]
    rng = np.random.RandomState(5)
    for _ in range(2000):
        a.append(f(rng.uniform(-4, 4)))
        b.append(f(rng.uniform(-2, 2)))
        c.append(f(rng.uniform(-2, 2)))
    a, b, c = (np.array(v, np.float32) for v in (a, b, c))
    got = _fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] != want[0]          # the double-rounding case is real
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_mandelbrot_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        mandelbrot_cuda(torch.zeros((2, 2)), torch.zeros((2, 2)), max_iter=4)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("uts_hash")
    assert list(tmp_path.iterdir()) == []


# -- hand kernels on the card ---------------------------------------------------

@pytest.mark.cuda
def test_uts_hash_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.RandomState(3)
    n = 5000
    par = _i32(rng.randint(0, 2**32, size=(5, n), dtype=np.uint64)
               .astype(np.uint32)).to(cuda_device)
    ix = _i32(rng.randint(0, 64, size=n).astype(np.uint32)).to(cuda_device)
    assert torch.equal(uts_hash_cuda(par, ix), uts_child_digests_ref(par, ix))


@pytest.mark.cuda
def test_mandelbrot_kernel_matches_plain_on_card(cuda_device):
    cre, cim = (torch.from_numpy(a.copy()).to(cuda_device)
                for a in _planes((256, 256)))
    assert torch.equal(mandelbrot_cuda(cre, cim, max_iter=512),
                       mandelbrot_ref(cre, cim, 512))
