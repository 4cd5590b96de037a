"""flax's `Module.init` draw, reproduced without JAX.

`model.init(jax.random.PRNGKey(seed), x)` gives every parameter its own
key and fills it with its initializer. This module computes the same
numbers with numpy, so that the port's seed `s` starts where the JAX
package's `PRNGKey(s)` does:

- threefry2x32 (20 rounds, JAX `prng._threefry2x32_lowering`), `PRNGKey`,
  `fold_in` and `split` of the raw uint32[2] key;
- `random_bits` in the partitionable form (`jax_threefry_partitionable`,
  on by default): element i of a shape hashes the 64-bit counter i, split
  into (hi, lo) words, and its 32 bits are the two output words xor-ed;
- `uniform` (bits -> mantissa of [1, 2), minus 1, scaled), and
  `truncated_normal` (a uniform in [erf(lower/sqrt2), erf(upper/sqrt2)],
  sqrt2 * erf_inv, clipped inside the bounds) with XLA's single-precision
  erf_inv polynomial (Giles) and its CPU log1p, all in float32, each
  multiply-add that XLA's CPU code contracts rounded once (`_fma`);
- flax's key for a parameter: `fold_in(root, sha1(path..., n))[:4]`, where
  path is the module names from the root and n counts the `self.param`
  calls of that module so far, the first being 1 (flax
  `core/scope._fold_in_static` and `Scope.make_rng`);
- the leaf initializers of the JAX models: kernels `lecun_normal`
  (variance 1 / fan_in on the flax HWIO shape, a normal truncated at two
  standard deviations and rescaled by 0.87962566103423978), biases 0,
  BatchNorm scale 1, shift 0, mean 0, variance 1.

`init_state_dict(model, seed)` draws in flax's shapes and names (through
`models/weights.state_dict_to_flax`) and converts back with
`flax_to_state_dict`; nothing is drawn in OIHW.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf(-2 / sqrt(2)) and erf(2 / sqrt(2)) in float32, as XLA rounds them
_ERF_LO = np.array(3212073496, _U32).view(np.float32)
_ERF_HI = np.array(1064589848, _U32).view(np.float32)
# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = np.float32(.87962566103423978)
# XLA ErfInv32 (Giles, "Approximating the erfinv function"), highest
# degree first
_ERFINV_SMALL = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941], np.float32)
_ERFINV_LARGE = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682], np.float32)
# XLA's CPU logf (Cephes) and log1p (Cephes rational) coefficients
_LOG_P = np.array(
    [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
     3.3333331174e-1], np.float32)
_LOG1P_NUM = np.array(
    [4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
     6.5787325942061044846969e0, 2.9911919328553073277375e1,
     6.0949667980987787057556e1, 5.7112963590585538103336e1,
     2.0039553499201281259648e1], np.float32)
_LOG1P_DEN = np.array(
    [1., 1.5062909083469192043167e1, 8.3047565967967209469434e1,
     2.2176239823732856465394e2, 3.0909872225312059774938e2,
     2.1642788614495947685003e2, 6.0118660497603843919306e1], np.float32)
_CHUNK = 1 << 20   # elements drawn by one thread at a time

Key = np.ndarray   # uint32[2]


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the uint32 counter words (x0, x1)
    under `key` (two words, each a scalar or an array like the counters),
    elementwise: JAX's `threefry2x32_p`."""
    k0, k1 = np.asarray(key[0], _U32), np.asarray(key[1], _U32)
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, _U32) + ks[0]
        b = np.asarray(x1, _U32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)`'s data for a seed in [0, 2**32)."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return np.array([0, seed], _U32)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    a, b = threefry2x32(key, np.array([0], _U32),
                        np.array([data & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def split(key: Key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` (partitionable form): uint32[num, 2]."""
    a, b = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=1)


def _bits(keys: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Bits of the 64-bit counters `idx` under per-element `keys`."""
    a, b = threefry2x32(keys.T, (idx >> np.uint64(32)).astype(_U32),
                        idx.astype(_U32))
    return a ^ b


def _chunked(fn, jobs: Sequence[Tuple[Key, Tuple[int, ...]]]
             ) -> List[np.ndarray]:
    """[fn(keys, counters) of each (key, shape) job, shaped]: the jobs'
    elements laid end to end and cut in chunks that a pool of torch's
    intra-op thread count maps (numpy's elementwise loops release the
    GIL); each element carries its job's key and its own row-major index
    in the job."""
    sizes = np.array([int(np.prod(shape, dtype=np.int64)) for _, shape in jobs],
                     np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    table = np.array([k for k, _ in jobs], _U32).reshape(-1, 2)

    def chunk(lo: int) -> np.ndarray:
        pos = np.arange(lo, min(starts[-1], lo + _CHUNK), dtype=np.int64)
        job = np.searchsorted(starts, pos, side="right") - 1
        return fn(table[job], (pos - starts[job]).astype(np.uint64))

    los = range(0, max(1, int(starts[-1])), _CHUNK)
    with concurrent.futures.ThreadPoolExecutor(
            min(len(los), torch.get_num_threads())) as pool:
        flat = np.concatenate(list(pool.map(chunk, los)))
    return [flat[starts[i]:starts[i + 1]].reshape(shape)
            for i, (_, shape) in enumerate(jobs)]


def random_bits(key: Key, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`: the counter of element i
    (row-major) is the 64-bit i as words (i >> 32, i & 0xffffffff)."""
    return _chunked(_bits, [(key, tuple(shape))])[0]


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding, as XLA's CPU code contracts
    a multiply feeding an add (the float32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner's rule, highest degree first, each step one fma."""
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _uniform(bits: np.ndarray, lo: np.float32, hi: np.float32
             ) -> np.ndarray:
    floats = ((bits >> _U32(32 - 23)) | _U32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def uniform(key: Key, shape: Sequence[int], minval=0.0, maxval=1.0
            ) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return _uniform(random_bits(key, shape), np.float32(minval),
                    np.float32(maxval))


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 log (Cephes logf: x = m * 2^e with m in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1) for positive
    normal x, the only inputs `erf_inv` gives it."""
    f32 = np.float32
    m = np.maximum(np.array(0x00800000, _U32).view(f32), x)
    e = f32(1) + ((m.view(np.int32) >> 23) - 0x7F).astype(f32)
    m = ((m.view(_U32) & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(f32)
    below = m < f32(0.707106781186547524)
    t = m - f32(1)
    e = e - np.where(below, f32(1), f32(0))
    t = t + np.where(below, m, f32(0))
    x2 = t * t
    x3 = x2 * t
    c = _LOG_P
    y = _fma(_fma(t, c[0], c[1]), t, c[2])
    y1 = _fma(_fma(t, c[3], c[4]), t, c[5])
    y2 = _fma(_fma(t, c[6], c[7]), t, c[8])
    y = _fma(_fma(_fma(y, x3, y1), x3, y2), x3, f32(-2.12194440e-4) * e)
    t = t - f32(0.5) * x2
    return (t + y) + f32(0.693359375) * e


def _log1p(z: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p: a Cephes rational approximation below
    |z| = sqrt(2) - 1, log(1 + z) above."""
    f32 = np.float32
    z2 = z * z
    small = z + _fma(f32(-0.5), z2, (z * z2) * (_poly(z, _LOG1P_NUM)
                                               / _poly(z, _LOG1P_DEN)))
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log(z + f32(1))
    return np.where(np.abs(z) < f32(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ErfInv on (-1, 1): Giles' polynomial in
    w = -log1p(-x^2), one set of coefficients below w = 5 and one above."""
    x = np.asarray(x, np.float32)
    w = -_log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, cs, cl))
    return p * x


def _truncated_normal(keys: np.ndarray, idx: np.ndarray) -> np.ndarray:
    u = _uniform(_bits(keys, idx), _ERF_LO, _ERF_HI)
    return np.clip(np.float32(np.sqrt(2)) * erf_inv(u),
                   np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf)))


def truncated_normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.truncated_normal(key, -2, 2, shape, float32)`."""
    return _chunked(_truncated_normal, [(key, tuple(shape))])[0]


def param_key(root: Key, path: Sequence[str], count: int) -> Key:
    """flax's key of the `count`-th `self.param` call (from 1) of the
    module at `path` (module names from the root) under `root`."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def fan_in(shape: Sequence[int]) -> float:
    """flax's fan-in of a kernel of flax `shape` (HWIO; a ConvTranspose
    kernel is (kh, kw, in, out) too): kh * kw * in, computed as
    `jax.nn.initializers._compute_fans` does."""
    in_size, out_size = shape[-2], shape[-1]
    receptive = float(np.prod(shape)) / in_size / out_size
    return in_size * receptive


def _lecun_stddev(shape: Sequence[int]) -> np.float32:
    variance = np.float32(1.0 / fan_in(shape))
    return np.sqrt(variance) / _TRUNC_STD


def lecun_normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """`flax.linen.initializers.lecun_normal()(key, shape, float32)`."""
    return truncated_normal(key, shape) * _lecun_stddev(shape)


# the order of a flax module's `self.param` calls: nn.Conv / ConvTranspose
# / Dense and the JAX package's `_ConvParams` make 'kernel' then 'bias';
# nn.BatchNorm and `_BNParams` make 'scale' then 'bias'
_PARAM_ORDER = ("kernel", "scale", "bias")


def _init_tree(tree: Mapping, root: Key, path: Tuple[str, ...],
               kernels: List) -> Dict:
    out: Dict = {}
    params = [k for k in _PARAM_ORDER if k in tree
              and not isinstance(tree[k], Mapping)]
    for name, node in tree.items():
        if isinstance(node, Mapping):
            out[name] = _init_tree(node, root, path + (name,), kernels)
            continue
        shape = tuple(node) if isinstance(node, tuple) else np.shape(node)
        if name == "kernel":
            key = param_key(root, path, params.index(name) + 1)
            kernels.append((out, key, shape))
        elif name in ("scale", "var"):
            out[name] = np.ones(shape, np.float32)
        elif name in ("bias", "mean"):
            out[name] = np.zeros(shape, np.float32)
        else:
            raise KeyError(f"{'/'.join(path + (name,))}: no flax init rule")
    return out


def init_variables(tree: Mapping, seed: Union[int, Key]) -> Dict:
    """`model.init(PRNGKey(seed), x)` of a flax variables tree
    {'params', 'batch_stats'} whose leaves give the shapes (arrays or
    shape tuples): every kernel `lecun_normal` from its own key, the other
    leaves at their constant init (biases and means 0, scales and
    variances 1)."""
    root = prng_key(seed) if isinstance(seed, int) else np.asarray(
        seed, _U32)
    kernels: List = []
    out = {col: _init_tree(sub, root, (), kernels)
           for col, sub in tree.items()}
    drawn = _chunked(_truncated_normal, [(k, s) for _, k, s in kernels])
    for (node, _, shape), value in zip(kernels, drawn):
        node["kernel"] = value * _lecun_stddev(shape)
    return out


def init_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """The port `state_dict` that flax's `init` with `PRNGKey(seed)` gives
    the JAX twin of `model`, drawn in flax's names and HWIO shapes."""
    from human_body_proportion_estimation_tpu_torch.models.weights import (
        flax_to_state_dict,
        state_dict_to_flax,
    )
    shapes = state_dict_to_flax({
        k: torch.empty(v.shape) for k, v in model.state_dict().items()
        if v.is_floating_point()})
    return flax_to_state_dict(init_variables(shapes, seed))
