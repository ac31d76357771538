"""float32 arithmetic of the JAX reference, as XLA compiles it for the CPU.

The port is held against the JAX package run on the CPU (Pallas interpret
mode), and its golden rows were rendered there.  XLA:CPU does not round
op for op like plain PyTorch:

  * it contracts ``a * b + c`` into one fused multiply-add wherever the
    product has a single use inside one fusion (LLVM's FMA combine);
  * its float32 ``exp`` and ``log`` are Cephes-style polynomials, not the
    libm ones;
  * its float32 ``rsqrt`` is Newton steps seeded with the host's x86
    rsqrt estimate (``vrsqrtps``).  The estimate is the CPU's own: on one
    host it is a table of 12-bit values indexed by the exponent parity and
    the top 10 mantissa bits (``RSQRT_SEED``, with two steps), on another
    it is not, and XLA takes one step there.

These helpers reproduce them, so the plain versions (``march``) and
the CUDA kernels (``csrc/march.cuh``, which takes ``RSQRT_SEED`` as an
argument) match the JAX reference bit for bit on the tested scenes
(tests/test_torch_tilemarch.py, tests/test_torch_slicemarch.py).  The
card's kernels and their plain versions on the card always take
``RSQRT_SEED`` and two steps.  CPU tensors take the host's model of
XLA:CPU, decided once from the host alone (``cpu_rsqrt_model``): where
the host's estimate is ``RSQRT_SEED``, that and two steps; elsewhere the
host's estimate and one step.  ``seed_rsqrt`` renders CPU tensors under
``RSQRT_SEED`` inside a block, the model the stored golden rows were
rendered under.  The FMA sites were read off XLA's
optimised LLVM IR of the interpret-mode kernel; each call site of
``fma`` names one.  ``rsqrt`` and ``log`` are autograd functions with
JAX's derivative rules (their bit views carry none), for the
differentiable path (``diff``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# XLA's float32 exp: clamp, range reduction by ln 2 in two parts, a
# degree-5 polynomial, scale by 2^n built from the exponent bits
EXP_LO = float.fromhex("-0x1.5f3334p+6")
EXP_HI = float.fromhex("0x1.633334p+6")
LOG2E = float.fromhex("0x1.715476p+0")
EXP_C1 = float.fromhex("0x1.63p-1")
EXP_C2 = float.fromhex("-0x1.bd0106p-13")
EXP_P = tuple(float.fromhex(h) for h in (
    "0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7",
    "0x1.555382p-5", "0x1.555554p-3",
)) + (0.5,)

# x86 rsqrt estimate: [parity of the unbiased exponent][top 10 mantissa
# bits] -> top 12 mantissa bits of the estimate, whose value lies in
# [0.5, 1) for an input in [1, 4); the estimate scales exactly by 2^-k
# for an input scaled by 4^k.  3 hex digits per entry.
_SEED_HEX = (
    "ffeffaff6ff2feefeafe6fe2fdefdafd6fd2fcefcbfc7fc3fbffbbfb7fb3faffabfa7fa4"
    "fa0f9cf98f94f90f8cf89f85f81f7df79f76f72f6ef6af66f63f5ff5bf57f54f50f4cf48"
    "f45f41f3df39f36f32f2ef2bf27f23f20f1cf18f15f11f0df0af06f02effefbef7ef4ef0"
    "eedee9ee5ee2edeedbed7ed3ed0eccec9ec5ec2ebeebaeb7eb3eb0eacea9ea5ea2e9ee9b"
    "e97e94e90e8de89e86e82e7fe7be78e75e71e6ee6ae67e63e60e5de59e56e52e4fe4ce48"
    "e45e41e3ee3be37e34e31e2de2ae26e23e20e1ce19e16e12e0fe0ce09e05e02dffdfbdf8"
    "df5df1deedebde8de4de1ddeddbdd7dd4dd1dcedcadc7dc4dc1dbedbadb7db4db1daedaa"
    "da7da4da1d9ed9bd97d94d91d8ed8bd88d84d81d7ed7bd78d75d72d6fd6bd68d65d62d5f"
    "d5cd59d56d53d50d4dd49d46d43d40d3dd3ad37d34d31d2ed2bd28d25d22d1fd1cd19d16"
    "d13d10d0dd0ad07d04d01cfecfbcf8cf5cf2cefcecce9ce6ce3ce0cddcdbcd8cd5cd2ccf"
    "ccccc9cc6cc3cc0cbdcbacb8cb5cb2cafcacca9ca6ca3ca1c9ec9bc98c95c92c8fc8dc8a"
    "c87c84c81c7ec7cc79c76c73c70c6ec6bc68c65c62c60c5dc5ac57c54c52c4fc4cc49c47"
    "c44c41c3ec3cc39c36c33c31c2ec2bc28c26c23c20c1ec1bc18c15c13c10c0dc0bc08c05"
    "c03c00bfdbfbbf8bf5bf3bf0bedbebbe8be5be3be0bddbdbbd8bd5bd3bd0bcebcbbc8bc6"
    "bc3bc0bbebbbbb9bb6bb3bb1baebacba9ba7ba4ba1b9fb9cb9ab97b95b92b8fb8db8ab88"
    "b85b83b80b7eb7bb79b76b73b71b6eb6cb69b67b64b62b5fb5db5ab58b55b53b50b4eb4b"
    "b49b46b44b41b3fb3db3ab38b35b33b30b2eb2bb29b26b24b22b1fb1db1ab18b15b13b11"
    "b0eb0cb09b07b05b02b00afdafbaf9af6af4af1aefaedaeaae8ae5ae3ae1adeadcadaad7"
    "ad5ad3ad0aceacbac9ac7ac4ac2ac0abdabbab9ab6ab4ab2aafaadaabaa8aa6aa4aa2a9f"
    "a9da9ba98a96a94a91a8fa8da8ba88a86a84a82a7fa7da7ba78a76a74a72a6fa6da6ba69"
    "a66a64a62a60a5da5ba59a57a55a52a50a4ea4ca49a47a45a43a41a3ea3ca3aa38a36a33"
    "a31a2fa2da2ba28a26a24a22a20a1da1ba19a17a15a13a10a0ea0ca0aa08a06a04a019ff"
    "9fd9fb9f99f79f59f29f09ee9ec9ea9e89e69e49e19df9dd9db9d99d79d59d39d19ce9cc"
    "9ca9c89c69c49c29c09be9bc9ba9b79b59b39b19af9ad9ab9a99a79a59a39a199f99d99b"
    "99999799499299098e98c98a98898698498298097e97c97a97897697497297096e96c96a"
    "96896696496296095e95c95a95895695495295094e94c94a94894694494294093e93c93a"
    "93893793593393192f92d92b92992792592392191f91d91b91991791691491291090e90c"
    "90a9089069049029008ff8fd8fb8f98f78f58f38f18ef8ed8ec8ea8e88e68e48e28e08de"
    "8dc8db8d98d78d58d38d18cf8ce8cc8ca8c88c68c48c28c18bf8bd8bb8b98b78b58b48b2"
    "8b08ae8ac8aa8a98a78a58a38a189f89e89c89a89889689589389188f88d88c88a888886"
    "88488388187f87d87b87a87887687487287186f86d86b86a86886686486286185f85d85b"
    "85a85885685485385184f84d84c84a84884684584384183f83e83c83a838837835833831"
    "83082e82c82b82982782582482282081f81d81b81981881681481381180f80d80c80a808"
    "8078058038028007fe7fd7fb7f97f77f67f47f27f17ef7ed7ec7ea7e87e77e57e37e27e0"
    "7de7dd7db7d97d87d67d47d37d17d07ce7cc7cb7c97c77c67c47c27c17bf7be7bc7ba7b9"
    "7b77b57b47b27b07af7ad7ac7aa7a87a77a57a47a27a079f79d79b79a798797795793792"
    "79078f78d78b78a78878778578478278077f77d77c77a77877777577477277176f76d76c"
    "76a76976776676476276175f75e75c75b75975875675475375175074e74d74b74a748747"
    "74574474274073f73d73c73a73973773673473373173072e72d72b72a728727725723722"
    "72071f71d71c71a71971771671471371171070e70d70b70a7087077057047037017006fe"
    "6fd6fb6fa6f86f76f56f46f26f16ef6ee6ec6eb6e96e86e66e56e46e26e16df6de6dc6db"
    "6d96d86d66d56d36d26d16cf6ce6cc6cb6c96c86c66c56c46c26c16bf6be6bc6bb6ba6b8"
    "6b76b56b46b26b16b06ae6ad6ab6aa6a86a76a66a46a36a169f69c69a69769469168e68c"
    "68968668368067e67b67867567367066d66a66766566265f65d65a65765465264f64c64a"
    "64764464163f63c63963763463162f62c62962762462161f61c61961761461260f60c60a"
    "6076056025ff5fd5fa5f85f55f25f05ed5eb5e85e65e35e05de5db5d95d65d45d15cf5cc"
    "5ca5c75c45c25bf5bd5ba5b85b55b35b05ae5ab5a95a75a45a259f59d59a598595593590"
    "58e58b58958758458257f57d57a57857657357156e56c56a56756556256055e55b559557"
    "55455254f54d54b54854654454153f53d53a53853653353152f52c52a52852552352151e"
    "51c51a51851551351150e50c50a5085055035014ff4fc4fa4f84f64f34f14ef4ed4ea4e8"
    "4e64e44e14df4dd4db4d94d64d44d24d04ce4cb4c94c74c54c34c04be4bc4ba4b84b64b3"
    "4b14af4ad4ab4a94a64a44a24a049e49c49a49749549349148f48d48b489486484482480"
    "47e47c47a47847647447146f46d46b46946746546346145f45d45b45945745545245044e"
    "44c44a44844644444244043e43c43a43843643443243042e42c42a42842642442242041e"
    "41c41a41841641441241040e40c40a4084064044024003fe3fd3fb3f93f73f53f33f13ef"
    "3ed3eb3e93e73e53e33e13e03de3dc3da3d83d63d43d23d03ce3cc3cb3c93c73c53c33c1"
    "3bf3bd3bc3ba3b83b63b43b23b03ae3ad3ab3a93a73a53a33a13a039e39c39a398396395"
    "39339138f38d38b38a38838638438238137f37d37b37937837637437237036f36d36b369"
    "36736636436236035e35d35b35935735635435235034f34d34b34934834634434234133f"
    "33d33b33a33833633433333132f32e32c32a32832732532332232031e31c31b319317316"
    "31431231130f30d30b30a3083063053033013002fe2fc2fb2f92f72f62f42f22f12ef2ed"
    "2ec2ea2e82e72e52e32e22e02df2dd2db2da2d82d62d52d32d12d02ce2cd2cb2c92c82c6"
    "2c52c32c12c02be2bc2bb2b92b82b62b42b32b12b02ae2ac2ab2a92a82a62a52a32a12a0"
    "29e29d29b29a29829629529329229028f28d28b28a28828728528428228127f27e27c27a"
    "27927727627427327127026e26d26b26a26826726526326226025f25d25c25a259257256"
    "25425325125024e24d24b24a24824724524424224123f23e23d23b23a238237235234232"
    "23122f22e22c22b22922822622522422222121f21e21c21b21921821621521421221120f"
    "20e20c20b20a2082072052042022012001fe1fd1fb1fa1f81f71f61f41f31f11f01ef1ed"
    "1ec1ea1e91e81e61e51e31e21e11df1de1dc1db1da1d81d71d51d41d31d11d01cf1cd1cc"
    "1ca1c91c81c61c51c41c21c11bf1be1bd1bb1ba1b91b71b61b51b31b21b01af1ae1ac1ab"
    "1aa1a81a71a61a41a31a21a019f19e19c19b19a19819719619419319219018f18e18c18b"
    "18a18818718618518318218117f17e17d17b17a17917717617517417217117016e16d16c"
    "16b16916816716516416316216015f15e15c15b15a15915715615515315215115014e14d"
    "14c14b14914814714614414314214113f13e13d13c13a13913813713513413313213012f"
    "12e12d12b12a12912812612512412312212011f11e11d11b11a119118117115114113112"
    "11010f10e10d10c10a1091081071061041031021011000fe0fd0fc0fb0fa0f80f70f60f5"
    "0f40f20f10f00ef0ee0ed0eb0ea0e90e80e70e50e40e30e20e10e00de0dd0dc0db0da0d9"
    "0d70d60d50d40d30d20d00cf0ce0cd0cc0cb0c90c80c70c60c50c40c30c10c00bf0be0bd"
    "0bc0bb0b90b80b70b60b50b40b30b10b00af0ae0ad0ac0ab0a90a80a70a60a50a40a30a2"
    "0a009f09e09d09c09b09a09909809609509409309209109008f08e08c08b08a089088087"
    "08608508408208108007f07e07d07c07b07a07907807607507407307207107006f06e06d"
    "06c06b06906806706606506406306206106005f05e05d05b05a059058057056055054053"
    "05205105004f04e04d04c04a04904804704604504404304204104003f03e03d03c03b03a"
    "03903803703603403303203103002f02e02d02c02b02a029028027026025024023022021"
    "02001f01e01d01c01b01a01901801701601501401301201101000f00e00d00c00b00a009"
    "008007006005004003002001"
)
RSQRT_SEED = np.array(
    [int(_SEED_HEX[i:i + 3], 16) for i in range(0, len(_SEED_HEX), 3)],
    dtype=np.int32,
).reshape(2, 1024)


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else float(v)


def _tracked(*xs) -> bool:
    """True when autograd (reverse mode, or a dual level of forward mode)
    may differentiate through ``xs``."""
    import torch.autograd.forward_ad as fwAD

    if fwAD._current_level >= 0:
        return True
    return torch.is_grad_enabled() and any(
        isinstance(x, Tensor) and x.requires_grad for x in xs)


_LOW29, _HALF_ULP32 = (1 << 29) - 1, 1 << 28


def fma_reference(a, b, c) -> Tensor:
    """The plain version of ``fma``'s value, on any device: float32 ``a * b
    + c`` rounded once.  The float64 product of two float32 values is
    exact, so one float64 ``addcmul`` rounds the exact sum once, and its
    float32 cast rounds it again.  The two roundings differ from one only
    where the float64 sum lies exactly halfway between two float32 values:
    2^28 in its low 29 bits in float32's normal range, or a nonzero sum at
    or below float32's least normal magnitude.  Only those elements take
    the exact form: the float64 sum rounded to odd (truncated towards
    zero, its last bit set where it was inexact, by TwoSum's error term),
    which float64's 29 bits beyond float32's 24 cast as the exact sum
    would.  No derivatives."""
    dev = next((v.device for v in (a, b, c)
                if isinstance(v, Tensor) and v.device.type != "cpu"), torch.device("cpu"))
    a64, b64, c64 = (v.detach().to(dev, torch.float64) if isinstance(v, Tensor) else
                     torch.tensor(float(v), dtype=torch.float64, device=dev) for v in (a, b, c))
    s = torch.addcmul(c64, a64, b64)  # one rounding: the product is exact
    if s.dim() == 0:
        return fma_reference(a64[None], b64[None], c64[None])[0]
    out = s.float()
    flag = (s.view(torch.int64) & _LOW29) == _HALF_ULP32
    flag |= (out.abs() <= MIN_NORMAL) & (s != 0.0)
    if not bool(flag.any()):
        return out
    at = flag.nonzero(as_tuple=True)
    x, y, z = (v.expand(s.shape)[at] for v in (a64, b64, c64))
    p = x * y  # exact
    t = s[at]
    back = t - p
    err = (p - (t - back)) + (z - back)  # p + z == t + err exactly (NaN past inf)
    e = err * torch.sign(t)  # exact: negative where t lies beyond the exact sum
    bits = (t.view(torch.int64) - (e < 0.0).long()) | (e.abs() > 0.0).long()
    out[at] = bits.view(torch.float64).float()
    return out


def fma(a, b, c) -> Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn`` and XLA's
    contracted FMA round it: every FMA site of the port's PyTorch code.
    With a CUDA tensor among the operands (float32 tensors, and numbers
    that float32 holds), one launch of ``csrc/numerics.cu``'s kernel,
    counted in ``fma.launches``; otherwise ``fma_reference``.  Derivatives
    (``_Fma``) are those autograd forms for ``(a * b + c)`` in float64
    cast to float32; the rounding carries none."""
    if _tracked(a, b, c):
        return _Fma.apply(a, b, c)
    return _fma_value(a, b, c)


def _fma_value(a, b, c) -> Tensor:
    values = [v.detach() if isinstance(v, Tensor) else v for v in (a, b, c)]
    if any(isinstance(v, Tensor) and v.device.type == "cuda" for v in values):
        return _fma_launch(*values)
    return fma_reference(*values)


class _Fma(torch.autograd.Function):
    """``fma`` under autograd: the value rounded once, the derivatives of
    ``(a.double() * b.double() + c.double()).float()`` formed as autograd
    forms them (products in float64, reduced to each operand's shape, then
    cast), so that they equal bit for bit what that expression gives."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.numbers = tuple(None if isinstance(v, Tensor) else v for v in (a, b, c))
        tensors = [v for v in (a, b, c) if isinstance(v, Tensor)]
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)
        return _fma_value(a, b, c)

    @staticmethod
    def _operands(ctx):
        saved = iter(ctx.saved_tensors)
        return [next(saved) if n is None else n for n in ctx.numbers]

    @staticmethod
    def backward(ctx, g):
        a, b, c = _Fma._operands(ctx)
        g64 = g.double()
        grads = (g64 * _f64(b), g64 * _f64(a), g64)
        return tuple(d.sum_to_size(v.shape).float() if need else None
                     for v, d, need in zip((a, b, c), grads, ctx.needs_input_grad))

    @staticmethod
    def jvp(ctx, ta, tb, tc):
        # mul's forward rule (other_t * self_p + self_t * other_p), add's
        # (self_t + other_t), then the cast
        a, b, c = _Fma._operands(ctx)
        terms = [t.double() * _f64(p) for t, p in ((tb, a), (ta, b)) if t is not None]
        t = terms[0] + terms[1] if len(terms) == 2 else (terms[0] if terms else None)
        if tc is not None:
            t = tc.double() if t is None else t + tc.double()
        if t is None:
            return torch.zeros_like(_fma_value(a, b, c))
        return t.float()


fma.launches = 0


def fma_layout(ops, dev):
    """How ``fma``'s kernel walks its operands on ``dev``: ``(tensors,
    values, walk)``.  Each tensor operand on ``dev`` goes as itself, each
    number (or 0-d tensor elsewhere) as None and its value; ``walk`` is the
    ``FmaWalk`` that ``_fma_plan`` makes from the operands' shapes, strides
    and 16-byte alignment, once for each."""
    tensors, values, specs = [], [], []
    for v in ops:
        if isinstance(v, Tensor) and (v.device == dev or v.dim() > 0):
            if v.device != dev or v.dtype != torch.float32:
                raise ValueError(f"fma on {dev} takes float32 tensors on it, not a "
                                 f"{v.dtype} tensor on {v.device}")
            tensors.append(v)
            values.append(0.0)
            specs.append((v.shape, v.stride(), v.data_ptr() % 16 == 0))
        else:
            x = float(v)
            if float(np.float32(x)) != x and x == x:
                raise ValueError(f"fma on {dev} takes numbers that float32 holds, not {x!r}")
            tensors.append(None)
            values.append(x)
            specs.append(None)
    return tensors, values, _fma_plan(tuple(specs))


# how the kernel reads an operand over a thread's run of FMA_RUN outputs
# (csrc/numerics.cu): one scalar load an output, one 16-byte load, or one
# load for the whole run
GENERAL, VECTOR, CONSTANT = 0, 1, 2
FMA_RUN = 4  # consecutive outputs a thread writes (csrc/numerics.cu kRun)
_FMA_DIMS = 8  # csrc/numerics.cu kDims
# threads a launch aims at when it splits a looped dimension into chunks:
# two waves of 2048 threads on each of the H100's 132 SMs
_FMA_THREADS = 2 * 2048 * 132


class FmaWalk(NamedTuple):
    """``fma``'s walk of its output, planned on the host.  The output of
    ``shape`` is ``loop`` rows of ``inner`` = prod(``sizes``) elements
    (``loop`` is 1 unless an operand repeats along the outermost dimension
    and ``inner`` is a multiple of FMA_RUN).  A thread writes one run of
    FMA_RUN consecutive elements of a row (the last run of a row may be
    shorter: a scalar tail) in ``chunk`` consecutive rows.  Per operand
    (None for a number): its element strides over ``sizes`` and along the
    rows, and how it is read over a run (``modes``)."""
    shape: torch.Size
    loop: int
    chunk: int
    sizes: tuple  # row-major, merged, no dimension of size 1 (at least one)
    divisors: tuple  # (magic, shift) of each size: fma_divide
    strides: tuple
    loop_strides: tuple
    modes: tuple
    wide: bool  # 64-bit offsets

    @property
    def inner(self) -> int:
        return math.prod(self.sizes)


def fma_divisor(d: int):
    """``(magic, shift)`` such that ``fma_divide(n, magic, shift) == n //
    d`` for every ``n`` below 2^31 and ``d`` in [1, 2^31): the division the
    kernel makes with a multiply-high, an add and a shift (PyTorch's
    ``IntDivider``)."""
    shift = max(d - 1, 0).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fma_divide(n: int, magic: int, shift: int) -> int:
    """``(__umulhi(n, magic) + n) >> shift`` in 32-bit unsigned arithmetic."""
    return (((n * magic) >> 32) + n) >> shift


def _merge(sizes, strides):
    """Merge dimension d into d + 1 where every operand steps across both
    as one run, and drop dimensions of size 1 (keeping one)."""
    sizes, strides = list(sizes), [list(st) for st in strides]
    for d in range(len(sizes) - 2, -1, -1):
        if all(st[d] == st[d + 1] * sizes[d + 1] for st in strides):
            sizes[d + 1] *= sizes[d]
            del sizes[d]
            for st in strides:
                del st[d]
    keep = [k for k, n in enumerate(sizes) if n != 1] or [len(sizes) - 1]
    return [sizes[k] for k in keep], [[st[k] for k in keep] for st in strides]


def _mode(sizes, strides, loop_stride, aligned) -> int:
    """How an operand with ``strides`` over ``sizes`` is read over a run:
    CONSTANT where the run lies within a block of the innermost dimensions
    over which its stride is 0, VECTOR where it lies within a block over
    which the operand is contiguous and every such block starts 16 bytes
    aligned, GENERAL otherwise."""
    inner = math.prod(sizes)
    zero = contiguous = 1
    for n, st in zip(reversed(sizes), reversed(strides)):
        if st != 0:
            break
        zero *= n
    if zero % FMA_RUN == 0 or zero == inner:
        return CONSTANT
    d = len(sizes) - 1
    while d >= 0 and strides[d] == contiguous:
        contiguous *= sizes[d]
        d -= 1
    if ((contiguous % FMA_RUN == 0 or contiguous == inner) and aligned
            and all(st % FMA_RUN == 0 for st in (*strides[:d + 1], loop_stride))):
        return VECTOR
    return GENERAL


@functools.lru_cache(maxsize=1024)
def _fma_plan(specs) -> FmaWalk:
    """``fma_layout``'s ``FmaWalk`` from each operand's ``(shape, strides,
    16-byte aligned)``, or None for a number."""
    shapes = [sp[0] for sp in specs if sp is not None]
    ndim = max(len(sh) for sh in shapes)
    shape = []
    for d in range(ndim):
        sizes_d = {sh[d - ndim + len(sh)] for sh in shapes if d - ndim + len(sh) >= 0}
        n = max(sizes_d)
        if not sizes_d <= {1, n}:
            raise ValueError(f"fma operands of shapes {shapes} do not broadcast")
        shape.append(n)
    shape = torch.Size(shape)
    tensor_specs = [sp for sp in specs if sp is not None]
    strides = []
    for sp in tensor_specs:
        st = [0] * max(ndim, 1)
        for d in range(len(sp[0])):
            k = d + ndim - len(sp[0])
            if sp[0][d] == shape[k] and shape[k] != 1:
                st[k] = sp[1][d]
        strides.append(st)
    sizes, strides = _merge(list(shape) or [1], strides)
    # loop over the outermost dimension where an operand repeats along it
    # (its values stay in the thread's registers) and rows keep runs aligned
    loop, loop_strides = 1, [0] * len(strides)
    if (len(sizes) > 1 and any(st[0] == 0 for st in strides)
            and math.prod(sizes[1:]) % FMA_RUN == 0):
        loop, sizes = sizes[0], sizes[1:]
        loop_strides = [st[0] for st in strides]
        strides = [st[1:] for st in strides]
    if len(sizes) > _FMA_DIMS:
        raise ValueError(f"fma takes at most {_FMA_DIMS} dimensions that do not merge, "
                         f"not {len(sizes)}")
    inner = math.prod(sizes)
    runs = -(-inner // FMA_RUN)
    chunks = min(loop, max(1, -(-_FMA_THREADS // runs)))
    chunk = max(-(-loop // chunks), -(-loop // 65535))  # at most 65535 grid rows
    numel = math.prod(shape)
    reach = max([numel] + [sum((n - 1) * s for n, s in zip((loop, *sizes), (ls, *st))) + 1
                           for st, ls in zip(strides, loop_strides)])
    found = iter(zip(tensor_specs, strides, loop_strides))
    per_op = []
    for sp in specs:
        if sp is None:
            per_op.append((None, None, None))
            continue
        _, st, ls = next(found)
        per_op.append((tuple(st), ls, _mode(sizes, st, ls, sp[2])))
    return FmaWalk(shape, loop, chunk, tuple(sizes),
                   tuple(fma_divisor(n) for n in sizes), *zip(*per_op),
                   reach >= 2 ** 31)


def _fma_launch(*ops) -> Tensor:
    """``fma``'s kernel on the operands' CUDA device (``fma_layout``)."""
    from . import _build

    dev = next(v.device for v in ops if isinstance(v, Tensor) and v.device.type == "cuda")
    tensors, values, walk = fma_layout(ops, dev)
    out = torch.empty(walk.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = _build.load("numerics").avr_fma_launch(
        *(None if t is None else t.data_ptr() for t in tensors), out.data_ptr(), *values,
        _fma_array(walk), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fma kernel launch failed: CUDA error {rc}")
    fma.launches += 1
    return out


@functools.lru_cache(maxsize=1024)
def _fma_array(walk: FmaWalk):
    """The kernel's plan (csrc/numerics.cu ``avr_fma_launch``): int64 words
    ndim, loop, chunk, wide; per operand its mode (-1: a number) and its
    loop stride; then kDims sizes, magics, shifts and each operand's
    strides."""
    import ctypes

    pad = lambda v: list(v) + [0] * (_FMA_DIMS - len(v))  # noqa: E731
    words = [len(walk.sizes), walk.loop, walk.chunk, int(walk.wide)]
    words += [-1 if m is None else m for m in walk.modes]
    words += [ls or 0 for ls in walk.loop_strides]
    words += pad(walk.sizes) + pad([m for m, _ in walk.divisors])
    words += pad([s for _, s in walk.divisors])
    for st in walk.strides:
        words += pad(st or ())
    return (ctypes.c_int64 * len(words))(*words)


def exp(x: Tensor) -> Tensor:
    """XLA's float32 ``exp``, operation for operation."""
    x = torch.clamp(x, EXP_LO, EXP_HI)
    n = torch.floor(fma(x, LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(-EXP_C1, n, x)
    r = fma(-EXP_C2, n, r)
    p = fma(r, EXP_P[0], EXP_P[1])
    for coef in EXP_P[2:]:
        p = fma(p, r, coef)
    y = fma(p, r * r, r) + 1.0
    return y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


# XLA's float32 log (Cephes, via Julien Pommier's SSE library): split off
# the exponent, a degree-8 polynomial in the mantissa around 1, ln 2 in two
# parts.  Coefficients as XLA's optimised IR spells them.
LOG_P = tuple(float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a370p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555ca0p-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2",
))
LOG_Q1 = float.fromhex("-0x1.bd0106p-13")
LOG_Q2 = float.fromhex("0x1.63p-1")
LOG_SQRTHF = float.fromhex("0x1.6a09e6p-1")
MIN_NORMAL = float.fromhex("0x1p-126")


def log(x: Tensor) -> Tensor:
    """XLA's float32 ``log``, operation for operation, including its
    treatment of subnormal inputs as zero (-inf).  Differentiable in both
    modes: the value goes through integer bit views, which carry no
    gradient, so autograd takes JAX's rule ``1 / x`` instead."""
    return _Log.apply(x)


def _log(x: Tensor) -> Tensor:
    x = torch.where(torch.abs(x) < MIN_NORMAL, 0.0, x)
    bits = torch.clamp(torch.nan_to_num(x, nan=0.0), min=MIN_NORMAL).view(torch.int32)
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < LOG_SQRTHF
    e = (((bits >> 23) - 127).float() + 1.0) - torch.where(small, 1.0, 0.0)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    t2 = t * t
    t3 = t2 * t
    y = fma(t, LOG_P[0], LOG_P[1])
    y1 = fma(t, LOG_P[3], LOG_P[4])
    y2 = fma(t, LOG_P[6], LOG_P[7])
    y = fma(y, t, LOG_P[2])
    y1 = fma(y1, t, LOG_P[5])
    y2 = fma(y2, t, LOG_P[8])
    y = fma(y, t3, y1)
    y = fma(y, t3, y2)
    y = fma(y, t3, LOG_Q1 * e)
    out = fma(LOG_Q2, e, fma(t2, -0.5, t) + y)
    out = torch.where(x == 0.0, -float("inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


_seed_tables: dict = {}  # device -> RSQRT_SEED on that device


def seed_table(dev: torch.device) -> Tensor:
    """The x86 rsqrt estimate table (``RSQRT_SEED``, int32) on ``dev``,
    copied there once: the kernels take it, and ``rsqrt_seed`` reads it
    without a copy from the host, so a CUDA graph can capture it."""
    table = _seed_tables.get(dev)
    if table is None:
        table = torch.from_numpy(RSQRT_SEED).to(dev).contiguous()
        _seed_tables[dev] = table
    return table


def rsqrt_seed(x: Tensor) -> Tensor:
    """The x86 rsqrt estimate of a positive normal float32 ``x``."""
    bits = x.view(torch.int32).long()
    e = ((bits >> 23) & 0xFF) - 127
    parity = e & 1
    mant = seed_table(x.device)[parity, (bits >> 13) & 0x3FF].long()
    return (((126 - ((e - parity) >> 1)) << 23) | (mant << 11)).int().view(
        torch.float32
    )


def rsqrt(x: Tensor) -> Tensor:
    """XLA's float32 ``rsqrt`` of a positive normal ``x``: Newton steps
    from the estimate (``RSQRT_SEED`` and two steps, or on CPU tensors
    ``cpu_rsqrt_model``'s).  Differentiable in both modes through JAX's
    rule ``-0.5 * (y / x)``, since the estimate's bit views carry no
    gradient."""
    return _Rsqrt.apply(x)


def _rsqrt(x: Tensor) -> Tensor:
    if x.device.type == "cpu" and not _seed_only and cpu_rsqrt_model() == "host":
        y, steps = host_rsqrt_estimate(x), 1
    else:
        y, steps = rsqrt_seed(x), 2
    for _ in range(steps):
        y = fma(y * -0.5, fma(x * y, y, -1.0), y)
    return y


# the host's estimate: _mm_rsqrt_ps, the instruction XLA:CPU seeds with
_HOST_RSQRT_C = r"""
#include <immintrin.h>
void avr_rsqrt_estimate(const float* x, float* y, long n) {
  long i = 0;
  for (; i + 4 <= n; i += 4) _mm_storeu_ps(y + i, _mm_rsqrt_ps(_mm_loadu_ps(x + i)));
  for (; i < n; ++i) _mm_store_ss(y + i, _mm_rsqrt_ss(_mm_load_ss(x + i)));
}
"""
_seed_only = False  # inside seed_rsqrt


@functools.lru_cache(maxsize=1)
def cpu_rsqrt_model() -> str:
    """The host's model of XLA:CPU's float32 rsqrt, for CPU tensors:
    ``"seed"`` (``RSQRT_SEED`` and two Newton steps) where the host's
    ``_mm_rsqrt_ps`` equals ``RSQRT_SEED`` at both ends of every entry of
    the table, or where it cannot be built (no C compiler, no x86 host);
    else ``"host"`` (the host's estimate and one step, as XLA takes on
    such a host).  Decided once."""
    try:
        _host_library()
    except RuntimeError:
        return "seed"
    top = torch.arange(2 * 1024, dtype=torch.int64)
    bits = ((127 + top // 1024) << 23) | ((top % 1024) << 13)
    x = torch.cat([bits, bits | 0x1FFF]).int().view(torch.float32)
    return "seed" if torch.equal(host_rsqrt_estimate(x), rsqrt_seed(x)) else "host"


@contextlib.contextmanager
def seed_rsqrt():
    """CPU tensors take ``RSQRT_SEED`` and two steps inside the block,
    whatever ``cpu_rsqrt_model`` says: the model of the card's kernels and
    of the hosts the stored golden rows were rendered on."""
    global _seed_only
    before, _seed_only = _seed_only, True
    try:
        yield
    finally:
        _seed_only = before


@functools.lru_cache(maxsize=1)
def _host_library():
    """The host estimate's C, built with ``cc`` into ``build/native/`` at
    first use (hashed name, under a lock); ``RuntimeError`` where it
    cannot be built."""
    import ctypes
    import fcntl
    import hashlib
    import os
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    folder = os.path.join(root, "build", "native")
    os.makedirs(folder, exist_ok=True)
    digest = hashlib.sha256(_HOST_RSQRT_C.encode()).hexdigest()[:16]
    path = os.path.join(folder, f"libavr_rsqrt_{digest}.so")
    with open(os.path.join(folder, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            fd, src = tempfile.mkstemp(suffix=".c", dir=folder)
            with os.fdopen(fd, "w") as f:
                f.write(_HOST_RSQRT_C)
            tmp = src[:-2] + ".so"
            try:
                subprocess.run([os.environ.get("CC", "cc"), "-O2", "-msse", "-shared", "-fPIC",
                                "-o", tmp, src], check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"the host rsqrt estimate does not build: {e}") from e
            finally:
                for f in (src, tmp):
                    if os.path.exists(f):
                        os.unlink(f)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise RuntimeError(f"the host rsqrt estimate does not load: {e}") from e
    lib.avr_rsqrt_estimate.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.avr_rsqrt_estimate.restype = None
    return lib


def host_rsqrt_estimate(x: Tensor) -> Tensor:
    """This CPU's ``_mm_rsqrt_ps`` of each element of a float32 CPU
    tensor (no gradient)."""
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    if src.numel():
        _host_library().avr_rsqrt_estimate(src.data_ptr(), out.data_ptr(), src.numel())
    return out


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return _log(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x

    @staticmethod
    def jvp(ctx, t):
        (x,) = ctx.saved_tensors
        return t / x


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _rsqrt(x)
        ctx.save_for_backward(x, y)
        ctx.save_for_forward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))

    @staticmethod
    def jvp(ctx, t):
        x, y = ctx.saved_tensors
        return t * (-0.5 * (y / x))


def tanf(x: float) -> float:
    """The C library's float32 ``tanf`` of a float32 ``x``, which XLA:CPU
    calls for a float32 ``tan`` (and its constant folder evaluates).  Not
    every libm rounds it correctly (glibc 2.36 misses the float32 nearest
    to the float64 ``tan`` on about 4% of arguments in [0, pi/2)), so the
    port calls the same function; without a loadable libm it rounds the
    float64 ``tan``."""
    import ctypes
    import ctypes.util
    import math

    global _TANF
    if _TANF is None:
        name = ctypes.util.find_library("m")
        try:
            fn = ctypes.CDLL(name).tanf if name else None
        except (OSError, AttributeError):
            fn = None
        if fn is not None:
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.c_float]
            _TANF = fn
        else:
            _TANF = lambda v: float(np.float32(math.tan(v)))  # noqa: E731
    return float(np.float32(_TANF(float(np.float32(x)))))


_TANF = None
