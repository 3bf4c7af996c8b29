"""Global host-side RNG for parameter sampling, and the one device draw.

Counterpart of ``torchio_tpu/random.py``. Transform parameters are
sampled on the host with numpy so they are concrete and JSON-serializable
for the history/replay system; the same :func:`seed` gives the same
parameters as the JAX package, draw for draw.

Heavy randomness (noise fields, bias fields) is drawn on the device from
an integer seed drawn here and recorded in the params. Every such draw
goes through :func:`device_normal`, which seeds a ``torch.Generator`` on
the batch's device: replaying a recorded seed regenerates the same field
within this package. It cannot reproduce ``jax.random``'s threefry bits,
so a test that compares the two packages replaces :func:`device_normal`
with a stand-in that derives the JAX package's keys from the same
arguments.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

_lock = threading.Lock()
_generator = np.random.default_rng()


def seed(value: int | None = None) -> None:
    """Seed the global parameter-sampling generator (like ``torch.manual_seed``)."""
    global _generator
    with _lock:
        _generator = np.random.default_rng(value)


def get_rng() -> np.random.Generator:
    """A generator safe to draw from in the calling thread.

    numpy Generators are not thread-safe. Each non-main thread gets its
    own child generator spawned (under the lock) from the global one, so
    draws never contend and streams never interleave. ``seed()``
    invalidates all children so reseeding stays deterministic
    single-threaded and fresh in workers.
    """
    if threading.current_thread() is threading.main_thread():
        return _generator
    epoch, gen = getattr(_tls, "gen", (None, None))
    if gen is None or epoch is not _generator:
        with _lock:
            gen = _generator.spawn(1)[0]
        _tls.gen = (_generator, gen)
    return gen


_tls = threading.local()


def uniform(lo: float, hi: float, size=None):
    return get_rng().uniform(lo, hi, size)


def random(size=None):
    return get_rng().random(size)


def draw_seed() -> int:
    """Draw a fresh 31-bit seed for a device draw."""
    return int(get_rng().integers(0, 2**31 - 1))


def device_normal(
    seed: int, shape: tuple[int, ...], device: torch.device | str, index: int
) -> torch.Tensor:
    """Standard normal float32 tensor of ``shape`` on ``device``.

    ``(seed, index)`` names the draw: ``seed`` is the recorded seed and
    ``index`` tells apart the draws one seed makes. Index 0 is the seed's
    own draw (BiasField). Noise draws ``2 n + 1`` for image ``n`` and,
    when Rician, ``2 n + 2`` for its second field. Each pair seeds its
    own generator through a 64-bit hash (the CPU generator reads only the
    low 32 bits of a seed), so a draw does not depend on the draws before
    it.
    """
    digest = hashlib.blake2b(f"{int(seed)}:{int(index)}".encode(), digest_size=8)
    generator = torch.Generator(device=device)
    generator.manual_seed(int.from_bytes(digest.digest(), "little"))
    return torch.randn(
        tuple(shape), generator=generator, device=device, dtype=torch.float32
    )
