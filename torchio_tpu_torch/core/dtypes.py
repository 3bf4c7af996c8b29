"""Dtype helpers: casts that follow the JAX package's conversions, signed
views for moving unsigned data, and numpy's names of torch dtypes."""

from __future__ import annotations

import torch


#: torch lacks some data-movement kernels (flip, gather, scatter,
#: ``where``; which ones depends on the version) for its wider unsigned
#: types: they move as the signed type of their width
_SIGNED_OF_WIDTH = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def cast_like_jax(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``values.astype(dtype)`` as XLA converts: a float to an integer type
    saturates at the type's range and NaN becomes 0, where torch's cast
    wraps (-1.5 to uint16 gives 65535 on the CPU) or is undefined. Every
    other cast is torch's own.

    When every value lies in the type's range (one ``aminmax`` pass and
    two scalars to the host), both casts truncate toward zero and torch's
    own runs: a resampled label map costs one pass, not five."""
    if not values.dtype.is_floating_point or dtype.is_floating_point or dtype == torch.bool:
        return values.to(dtype)
    info = torch.iinfo(dtype)
    if values.numel():
        low, high = (float(v) for v in torch.aminmax(values))
        if info.min <= low and high <= info.max:  # False for NaN
            # the wide unsigned types convert from int64, as below
            return values.to(torch.int64).to(dtype) if dtype in _SIGNED_OF_WIDTH else values.to(dtype)
    # float64 holds every bound of the integer types up to 32 bits exactly
    wide = torch.nan_to_num(values.to(torch.float64), nan=0.0)
    return wide.clamp(info.min, info.max).to(torch.int64).to(dtype)


def movable(data: torch.Tensor) -> torch.Tensor:
    """``data`` itself, or a view of its bits as the signed type of the
    same width where torch cannot move the unsigned type; ``.view(dtype)``
    of the result gives the original type back."""
    return data.view(_SIGNED_OF_WIDTH.get(data.dtype, data.dtype))


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32" for ``torch.float32``), as
    the JAX package prints its arrays' dtypes."""
    return str(dtype).removeprefix("torch.")
