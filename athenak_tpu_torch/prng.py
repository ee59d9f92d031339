"""Counter-based random numbers: the threefry2x32 stream of ``jax.random``.

The turbulence driver draws its Gaussian amplitudes exactly as the JAX
package does, with ``jax.random.PRNGKey``, ``split`` and ``normal`` under
the partitionable threefry of JAX (``jax_threefry_partitionable=True``,
the default since JAX 0.5).  Threefry 2x32 (Salmon et al. 2011, 20
rounds) is integer arithmetic, so the port reproduces the stream bit for
bit: every 32-bit word is held in an int64 tensor masked to 32 bits, on
the key's device.  A key is an int64 tensor ``[2]``: the high and low
words, as ``jax.random.PRNGKey`` lays them out.

``normal`` maps the bits to floats as ``jax.random.uniform`` does
(mantissa bits under an exponent of one, then scaled to
``[nextafter(-1, 0), 1)``) and applies the inverse error function as XLA
lowers it (Giles 2010, the single- and double-precision polynomials of
``jax/_src/pallas/utils.py:200-292``); torch's own ``erfinv`` differs
from it by tens of ulps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device="cpu"):
    """``jax.random.PRNGKey(seed)``: the seed's two 32-bit words, high
    first (the seed taken as a 64-bit integer)."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64, device=device)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    words (k1, k2); all int64 tensors of 32-bit words, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (x[0] + x[1]) & M32
            x = [a, _rotl(x[1], r) ^ a]
        x = [(x[0] + ks[(i + 1) % 3]) & M32,
             (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32]
    return x[0], x[1]


def _hash_iota(key, n: int):
    """Threefry of the 64-bit counters 0..n-1 split into (hi, lo) words."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], lo >> 32, lo & M32)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``: ``num`` new keys, ``[num, 2]``."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], dim=1)


def uniform_bits(key, shape, dtype):
    """Floats in [1, 2) from the key's random bits, as
    ``jax.random.uniform`` forms them before scaling."""
    n = math.prod(shape)
    b1, b2 = _hash_iota(key, n)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32).reshape(shape)
    if dtype == torch.float64:
        # the 64-bit word (b1 << 32 | b2) shifted right by 12
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64).reshape(shape)
    raise TypeError(f"normal draws float32 or float64, not {dtype}")


def normal(key, shape, dtype):
    """``jax.random.normal(key, shape, dtype)``."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    dev = key.device
    minval = torch.tensor(lo, dtype=dtype, device=dev)
    maxval = torch.tensor(1.0, dtype=dtype, device=dev)
    floats = uniform_bits(key, shape, dtype) - 1.0
    u = torch.maximum(minval, floats * (maxval - minval) + minval)
    return torch.tensor(math.sqrt(2.0), dtype=dtype, device=dev) * erfinv(u)


_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
           0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
           1.50140941)
_W_GT_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
           0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
           2.83297682)
_W_LT_625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_W_GT_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erfinv(x):
    """The inverse error function as XLA lowers ``chlo.erf_inv``."""
    w = -torch.log1p(x * -x)

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if x.dtype == torch.float32:
        lt5 = w < 5.0
        w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt5, c(_W_LT_5[0]), c(_W_GT_5[0]))
        for a, b in zip(_W_LT_5[1:], _W_GT_5[1:]):
            p = torch.where(lt5, c(a), c(b)) + p * w
    else:
        lt625, lt16 = w < 6.25, w < 16.0

        def coef(i):
            v = c(_W_LT_625[i])
            if i < 19:
                v = torch.where(lt625, v, c(_W_LT_16[i]))
            if i < 17:
                v = torch.where(lt16, v, c(_W_GT_16[i]))
            return v

        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, c(3.25), c(5.0)))
        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, coef(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt625, coef(i) + p * w, p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)
