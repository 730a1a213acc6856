"""Order-isomorphic packed (value, index) words: one plane instead of two.

Port of ``repro/core/packing.py``. The encoding is
``word = (key(v) << idx_bits) | i`` where ``key`` maps the value dtype to a
monotone signed-int32 keyspace:

- int32: ``key = v``.
- float32: bitcast to int32, then flip the low 31 bits of negatives
  (``key = b ^ ((b >> 31) & 0x7fffffff)``), after folding ``-0.0`` to
  ``+0.0`` so the two zeros compare equal. The map is an involution, so the
  same formula decodes — and a decoded zero is always ``+0.0``.

Comparing words compares ``(key, i)`` lexicographically, so the minimum word
is the leftmost minimum element. Layouts (``LAYOUTS``):

- ``packed64``: ``key << 32 | i`` in int64; exact for any int32/float32 data.
  torch has int64 natively, so there is no counterpart of the reference's
  ``ensure_x64``.
- ``packed32``: ``(key - kmin) << idx_bits | i`` in int32; fits when the
  observed key span and the index width share 31 bits (``fits_packed32``).
- ``quantized``: ``bucket(v) << idx_bits | i`` in int32 with a non-strictly
  monotone bucket code (at most 16 bits): engines break bucket ties with an
  exact value compare; the index field is always exact.

Structure padding uses ``pad_word(spec)``, strictly greater than every
encodable word. The torch helpers and their numpy twins (``*_np``, copied
from the reference) are bit-identical. ``spec_for`` measures ``x`` on the
host (one copy), so its ``kmin``/``qmin``/``qscale`` are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import to_numpy

__all__ = [
    "LAYOUTS",
    "PACKED_LAYOUTS",
    "PackSpec",
    "fits_packed32",
    "idx_bits_for",
    "pack",
    "pack_np",
    "pad_word",
    "spec_for",
    "unpack_idx",
    "unpack_idx_np",
    "unpack_val",
    "unpack_val_np",
    "word_dtype",
    "word_dtype_np",
    "word_nbytes",
]

# The ``packed=`` build-kwarg vocabulary.
LAYOUTS = ("unpacked", "packed64", "packed32", "quantized")
# Layouts that replace the (idx, val) planes with word planes.
PACKED_LAYOUTS = ("packed64", "packed32", "quantized")

_I32_MAX = (1 << 31) - 1


class PackSpec(NamedTuple):
    """Static description of a packed encoding (hashable, plain fields).

    ``kmin`` biases packed32 keys to non-negative; ``qmin``/``qscale`` place
    the quantized bucket grid; ``val_bits`` is the key/bucket field width
    (32 for packed64). Fields and methods are the reference's, so a spec
    round-trips through ``to_meta``/``from_meta`` in either package.
    """

    layout: str
    dtype: str  # value dtype name, e.g. "float32" / "int32"
    idx_bits: int
    val_bits: int
    kmin: int = 0
    qmin: float = 0.0
    qscale: float = 1.0

    def to_meta(self) -> dict:
        return dict(self._asdict())

    @classmethod
    def from_meta(cls, meta) -> "PackSpec":
        return cls(**{k: meta[k] for k in cls._fields})


def idx_bits_for(n_index: int) -> int:
    """Bits needed to address ``n_index`` slots (the *padded* length)."""
    if n_index <= 0:
        raise ValueError(f"n_index must be positive, got {n_index}")
    return max(1, int(n_index - 1).bit_length())


def fits_packed32(kmin: int, kmax: int, idx_bits: int) -> bool:
    """True when keys in [kmin, kmax] plus ``idx_bits`` fit one int32 word,
    with the max encodable word strictly below INT32_MAX (``pad_word``)."""
    if idx_bits >= 31:
        return False
    span = int(kmax) - int(kmin)
    return (span + 1) << idx_bits <= _I32_MAX


# --- monotone value <-> key maps -------------------------------------------


def _key_np(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v)
    if v.dtype == np.float32:
        b = (v + np.float32(0.0)).view(np.int32)  # -0.0 -> +0.0
        return b ^ ((b >> 31) & np.int32(_I32_MAX))
    if np.issubdtype(v.dtype, np.integer):
        return v.astype(np.int32)
    raise TypeError(f"unsupported value dtype for packing: {v.dtype}")


def _unkey_np(key: np.ndarray, dtype: str) -> np.ndarray:
    key = np.asarray(key, dtype=np.int32)
    if dtype == "float32":
        b = key ^ ((key >> 31) & np.int32(_I32_MAX))  # involution
        return b.view(np.float32)
    return key.astype(np.dtype(dtype))


def _key(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.float32:
        b = (v + 0.0).view(torch.int32)  # -0.0 -> +0.0
        return b ^ ((b >> 31) & _I32_MAX)
    if not v.dtype.is_floating_point and v.dtype != torch.bool:
        return v.to(torch.int32)
    raise TypeError(f"unsupported value dtype for packing: {v.dtype}")


def _unkey(key: torch.Tensor, dtype: str) -> torch.Tensor:
    key = key.to(torch.int32)
    if dtype == "float32":
        return (key ^ ((key >> 31) & _I32_MAX)).view(torch.float32)
    return key.to(getattr(torch, dtype))


# --- spec construction ------------------------------------------------------


def spec_for(x, n_index: int, layout: str = "auto") -> PackSpec:
    """Measure ``x`` (on the host) and build the PackSpec for ``layout``.

    ``n_index`` is the padded index domain the structure will address.
    ``layout="auto"`` picks packed32 when the observed key range fits, else
    packed64; an explicit ``"packed32"`` that does not fit raises.
    """
    xh = to_numpy(x)
    if xh.ndim != 1 or xh.size == 0:
        raise ValueError(f"spec_for wants a non-empty 1-D array, got {xh.shape}")
    dtype = str(xh.dtype)
    bits = idx_bits_for(n_index)
    keys = _key_np(xh)
    kmin, kmax = int(keys.min()), int(keys.max())

    if layout == "auto":
        layout = "packed32" if fits_packed32(kmin, kmax, bits) else "packed64"
    if layout == "packed64":
        return PackSpec("packed64", dtype, 32, 32, kmin=0)
    if layout == "packed32":
        if not fits_packed32(kmin, kmax, bits):
            raise ValueError(
                f"packed32 cannot encode key span [{kmin}, {kmax}] with "
                f"{bits} index bits; use layout='packed64' or 'auto'"
            )
        return PackSpec("packed32", dtype, bits, 31 - bits, kmin=kmin)
    if layout == "quantized":
        vbits = min(16, 31 - bits)  # int16-grade bucket codes
        if vbits < 1:
            raise ValueError(f"no bucket bits left for n_index={n_index}")
        lo = float(xh.min())
        hi = float(xh.max())
        span = hi - lo
        qscale = (span / float((1 << vbits) - 1)) if span > 0 else 1.0
        return PackSpec("quantized", dtype, bits, vbits, qmin=lo, qscale=qscale)
    raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")


def word_dtype(spec: PackSpec) -> torch.dtype:
    return torch.int64 if spec.layout == "packed64" else torch.int32


def word_dtype_np(spec: PackSpec):
    return np.int64 if spec.layout == "packed64" else np.int32


def pad_word(spec: PackSpec) -> int:
    """The +inf word: strictly greater than every encodable (key, i)."""
    return (1 << 63) - 1 if spec.layout == "packed64" else _I32_MAX


def word_nbytes(spec) -> int:
    """Bytes per packed word (8 for packed64, 4 otherwise)."""
    return 8 if getattr(spec, "layout", spec) == "packed64" else 4


# --- pack / unpack (torch) --------------------------------------------------


def _bucket(spec: PackSpec, v: torch.Tensor) -> torch.Tensor:
    """``floor((v - qmin) / qscale)`` clipped to the bucket range, in float32.

    The scalars are float32 tensors on ``v``'s device: a Python scalar
    divisor would let PyTorch's CUDA division multiply by its reciprocal,
    which is not the reference's IEEE quotient.
    """
    qmin = torch.tensor(spec.qmin, dtype=torch.float32, device=v.device)
    qscale = torch.tensor(spec.qscale, dtype=torch.float32, device=v.device)
    f = (v.to(torch.float32) - qmin) / qscale
    top = (1 << spec.val_bits) - 1
    return torch.clamp(torch.floor(f), 0, top).to(torch.int32)


def _bucket_np(spec: PackSpec, v: np.ndarray) -> np.ndarray:
    f = (np.asarray(v, np.float32) - np.float32(spec.qmin)) / np.float32(spec.qscale)
    nb = (1 << spec.val_bits) - 1
    return np.clip(np.floor(f), 0, nb).astype(np.int32)


def pack(spec: PackSpec, v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Encode values + indices into packed words (int64 for packed64, else
    int32). For ``quantized`` the word orders by (bucket, i): callers own the
    bucket-tie fallback; the index field is still exact."""
    i = i.to(torch.int32)
    if spec.layout == "packed64":
        return (_key(v).to(torch.int64) << 32) | i.to(torch.int64)
    if spec.layout == "packed32":
        key = _key(v) - spec.kmin  # in [0, span]: no overflow by the fit check
        return (key << spec.idx_bits) | i
    if spec.layout == "quantized":
        return (_bucket(spec, v) << spec.idx_bits) | i
    raise ValueError(f"cannot pack layout {spec.layout!r}")


def unpack_idx(spec: PackSpec, w: torch.Tensor) -> torch.Tensor:
    if spec.layout == "packed64":
        return (w & 0xFFFFFFFF).to(torch.int32)
    return w & ((1 << spec.idx_bits) - 1)


def unpack_val(spec: PackSpec, w: torch.Tensor) -> torch.Tensor:
    """Decode the value field (exact for packed64/packed32; undefined for
    quantized words, whose engines gather the exact value by index)."""
    if spec.layout == "packed64":
        return _unkey((w >> 32).to(torch.int32), spec.dtype)
    if spec.layout == "packed32":
        # Words are non-negative, so >> is exact; pads decode to garbage
        # values but never win a min over a non-empty range.
        return _unkey((w >> spec.idx_bits) + spec.kmin, spec.dtype)
    raise ValueError(f"unpack_val is undefined for layout {spec.layout!r}")


# --- pack / unpack (numpy twins) ----------------------------------------------


def pack_np(spec: PackSpec, v, i) -> np.ndarray:
    v = np.asarray(v, dtype=np.dtype(spec.dtype))
    i = np.asarray(i, np.int32)
    if spec.layout == "packed64":
        return (_key_np(v).astype(np.int64) << 32) | i.astype(np.int64)
    if spec.layout == "packed32":
        key = _key_np(v)
        if key.size and not (
            int(key.min()) >= spec.kmin and fits_packed32(spec.kmin, int(key.max()), spec.idx_bits)
        ):
            raise OverflowError(
                f"value keys [{int(key.min())}, {int(key.max())}] exceed the "
                f"packed32 spec range (kmin={spec.kmin}, idx_bits={spec.idx_bits})"
            )
        return ((key - np.int32(spec.kmin)) << spec.idx_bits) | i
    if spec.layout == "quantized":
        return (_bucket_np(spec, v) << spec.idx_bits) | i
    raise ValueError(f"cannot pack layout {spec.layout!r}")


def unpack_idx_np(spec: PackSpec, w) -> np.ndarray:
    w = np.asarray(w)
    if spec.layout == "packed64":
        return (w & np.int64(0xFFFFFFFF)).astype(np.int32)
    return (w & np.int32((1 << spec.idx_bits) - 1)).astype(np.int32)


def unpack_val_np(spec: PackSpec, w) -> np.ndarray:
    w = np.asarray(w)
    if spec.layout == "packed64":
        return _unkey_np((w >> 32).astype(np.int32), spec.dtype)
    if spec.layout == "packed32":
        return _unkey_np((w >> spec.idx_bits) + np.int32(spec.kmin), spec.dtype)
    raise ValueError(f"unpack_val is undefined for layout {spec.layout!r}")
