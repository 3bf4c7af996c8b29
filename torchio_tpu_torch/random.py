"""Global host-side RNG for parameter sampling, and the device draws.

Counterpart of ``torchio_tpu/random.py``. Transform parameters are
sampled on the host with numpy so they are concrete and JSON-serializable
for the history/replay system; the same :func:`seed` gives the same
parameters as the JAX package, draw for draw.

Heavy randomness (noise fields, bias fields) is drawn on the device from
an integer seed drawn here and recorded in the params. The draws are
``jax.random``'s own, with threefry2x32 in its counter mode (JAX's
``jax_threefry_partitionable``, on by default since jax 0.5):

- :func:`prng_key` is ``jax.random.PRNGKey``: a key is two 32-bit words;
- :func:`split` is ``jax.random.split``: key ``i`` of ``n`` is the
  threefry2x32 block of the counter pair ``(0, i)``;
- :func:`random_bits` is ``jax.random.bits``: element ``e`` of a draw
  (row-major) is ``x0 ^ x1`` of the block of the counter pair
  ``(e >> 32, e & 0xFFFFFFFF)``;
- :func:`key_uniform` is ``jax.random.uniform`` (the name ``uniform``
  stays the host draw of the parameter generator, as in the JAX
  package), and :func:`key_randint` is ``jax.random.randint`` for int32
  (``randint`` is the host draw);
- :func:`normal` is ``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` with
  ``u`` uniform on ``[nextafter(-1, 0), 1)`` and ``erf_inv`` Giles'
  single-precision polynomial, the one XLA evaluates.

Bits and uniforms are equal to JAX's bit for bit. Normals agree within a
few ulp of ``erf_inv``: ``log1p`` rounds differently in each library.
:func:`device_normal` names each draw a transform makes by its recorded
seed and an index, and derives the JAX package's key for it, so the same
seed gives the same noise and bias fields in both packages.

On a CPU device the draws run as plain integer torch ops (int64 holding
32-bit words); on a CUDA device :func:`random_bits`, :func:`normal` and
:func:`normals` launch the hand-written kernel of ``csrc/threefry.cu``
(:mod:`.ops.threefry_kernel`); :func:`key_randint` draws its two words
in one launch of that kernel's bits mode. :func:`normals` takes a list of draws,
each times its own scale, in one launch (BiasField's per-element fields,
Noise's Rician pair); its ``starts`` (the counter base) make a draw the
elements ``[start, start + n)`` of a larger one, so a rank of a device
mesh draws only its batch rows of a draw of the whole batch; with
``runs`` and ``pitches`` a draw is a strided region of a larger one (a
rank's J slab: :func:`slab_span`).
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from . import config

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


def randint(lo: int, hi: int, size=None):
    return get_rng().integers(lo, hi, size)


def choice(values, size=None, p=None):
    return get_rng().choice(values, size=size, p=p)


def draw_seed() -> int:
    """Draw a fresh 31-bit seed for a device draw."""
    return int(get_rng().integers(0, 2**31 - 1))


MASK32 = 0xFFFFFFFF
#: threefry2x32's rotations, used in turns for each group of four rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the Skein key-schedule parity constant
KEY_PARITY = 0x1BD11BDA
#: ``jax.random.normal``'s uniform range: ``nextafter(-1, 0)`` and 1 in
#: float32
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
NORMAL_HI = 1.0
SQRT2 = float(np.float32(np.sqrt(2.0)))
#: Giles' single-precision ``erf_inv`` (as XLA's ``ErfInv32``): the
#: polynomial's coefficients, highest degree first, for ``w < 5`` (on
#: ``w - 2.5``) and ``w >= 5`` (on ``sqrt(w) - 3``), ``w = -log1p(-x^2)``
ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)

Key = tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: JAX's ``threefry_seed``, ``(seed >>
    32, seed & 0xFFFFFFFF)``, of the seed as JAX holds it. The JAX package
    runs with 64-bit types off, so the seed is a 32-bit word (taken
    modulo 2^32) and the high word is 0."""
    word = int(seed) & MASK32
    return (0, word)


def key_injections(key: Key) -> tuple[int, ...]:
    """The ten words threefry2x32 adds to its state after each group ``g``
    of four rounds: ``x0 += w[2 g]``, ``x1 += w[2 g + 1]``, from the key
    schedule ``(k0, k1, k0 ^ k1 ^ KEY_PARITY)`` and the group's index."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ KEY_PARITY)
    return tuple(
        w for g in range(5) for w in (ks[(g + 1) % 3], (ks[(g + 2) % 3] + g + 1) & MASK32)
    )


def threefry2x32(key: Key, x0, x1):
    """The threefry2x32 block of the counter pairs ``(x0, x1)`` under
    ``key``: 20 rounds, the key injected after every 4. The words are
    Python ints or int64 tensors of 32-bit words; returns the two output
    words of the same kind."""
    inject = key_injections(key)
    x0 = (x0 + key[0]) & MASK32
    x1 = (x1 + key[1]) & MASK32
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 = x1 ^ x0
        x0 = (x0 + inject[2 * group]) & MASK32
        x1 = (x1 + inject[2 * group + 1]) & MASK32
    return x0, x1


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)``: key ``i`` is the block of the
    counter pair ``(0, i)`` (on the host, in Python ints)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def check_span(count: int, run, pitch) -> tuple[int | None, int | None]:
    """A draw's ``(run, pitch)``: ``(None, None)`` for one contiguous run
    (neither given), else a positive ``run`` (``count`` where None) and a
    ``pitch`` of at least ``run`` (``run`` where None)."""
    if run is None and pitch is None:
        return None, None
    run = int(count) if run is None else int(run)
    pitch = run if pitch is None else int(pitch)
    if run <= 0 or pitch < run:
        raise ValueError(f"a strided draw needs run > 0 and pitch >= run, got {run}, {pitch}")
    return run, pitch


def slab_span(shape, b0: int, bl: int, j0: int, jl: int) -> tuple[int, int, int, int]:
    """``(start, count, run, pitch)`` of the region ``[b0, b0 + bl) x
    [j0, j0 + jl)`` (dims 0 and 3) of a row-major draw of the 5-D
    ``shape`` (B, C, I, J, K): each (b, c, i) row of the region is a run
    of ``jl K`` counters, the runs ``J K`` apart. A whole J is one run."""
    _, c, si, sj, sk = (int(n) for n in shape)
    count = bl * c * si * jl * sk
    start = (b0 * c * si * sj + j0) * sk
    if jl == sj:
        return start, count, count, count
    return start, count, jl * sk, sj * sk


def bits_plain(key: Key, start: int, count: int, device, run=None, pitch=None) -> torch.Tensor:
    """Elements ``[start, start + count)`` of a flat draw of 32-bit words,
    as int64 in ``[0, 2^32)``: element ``e`` is ``x0 ^ x1`` of the block of
    the counter pair ``(e >> 32, e & 0xFFFFFFFF)``. With ``run`` and
    ``pitch``, element ``n`` is the draw's element ``start + (n // run) *
    pitch + n % run``. The plain version of the threefry kernel's bits."""
    flat = torch.arange(count, dtype=torch.int64, device=device)
    if run is not None and run < count:
        flat = (flat // run) * pitch + flat % run
    flat = flat + start
    x0, x1 = threefry2x32(key, flat >> 32, flat & MASK32)
    return x0 ^ x1


def as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2^32)`` -> a uint32 tensor of the same bits."""
    signed = torch.where(words >= 2**31, words - 2**32, words)
    return signed.to(torch.int32).view(torch.uint32)


def uniform_of_bits(words: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s map of 32-bit words (int64 in ``[0,
    2^32)``) to float32 on ``[lo, hi)``: the top 23 bits as the mantissa
    of a float in ``[1, 2)``, minus 1, times ``hi - lo`` plus ``lo`` (a
    separate multiply and add), at least ``lo``.

    On the normal's range (``hi - lo`` rounds to 2) and on ranges of a
    power-of-two width the product is exact, and the result is JAX's bit
    for bit. On other ranges XLA's CPU backend contracts the multiply and
    add into one FMA; the two roundings here then differ from it by at
    most one ulp of ``hi - lo``."""
    mantissa = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo32 = torch.tensor(lo, dtype=torch.float32, device=words.device)
    span = torch.tensor(hi, dtype=torch.float32, device=words.device) - lo32
    floats = mantissa - 1.0
    return torch.maximum(lo32, floats * span + lo32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision inverse error function on float32, step
    for step as XLA's ``ErfInv32`` and the threefry kernel: ``w =
    -log1p(-x^2)``; a degree-8 polynomial in ``w - 2.5`` (``w < 5``) or
    ``sqrt(w) - 3``, by Horner's rule with a separate multiply and add a
    step; times ``x``; ``erf_inv(+-1) = +-inf``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i: int) -> torch.Tensor:
        below, above = (
            torch.tensor(c[i], dtype=torch.float32, device=x.device)
            for c in (ERFINV_W_LT_5, ERFINV_W_GE_5)
        )
        return torch.where(lt, below, above)

    p = coefficient(0)
    for i in range(1, len(ERFINV_W_LT_5)):
        p = coefficient(i) + p * w
    edge = x * torch.inf
    return torch.where(x.abs() == 1.0, edge, p * x)


def normal_of_bits(words: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s map of 32-bit words to float32 normals."""
    u = uniform_of_bits(words, NORMAL_LO, NORMAL_HI)
    return torch.tensor(SQRT2, dtype=torch.float32, device=u.device) * erf_inv(u)


def _device(device) -> torch.device:
    """``device``, or the package's default device where it is None."""
    return config.default_device() if device is None else torch.device(device)


def random_bits(key: Key, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)``: a uint32 tensor of ``shape`` on
    ``device`` (the default device where None; the threefry kernel on a
    CUDA device)."""
    device = _device(device)
    shape = tuple(int(s) for s in shape)
    if device.type == "cuda":
        from .ops.threefry_kernel import threefry_bits_cuda

        return threefry_bits_cuda(key, shape, device)
    _check_cpu(device)
    return as_uint32(bits_plain(key, 0, math.prod(shape), device)).reshape(shape)


def key_uniform(
    key: Key, shape: tuple[int, ...], lo: float = 0.0, hi: float = 1.0, device=None
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on ``device``
    (the default device where None; on a CUDA device, the kernel's bits
    mapped by torch ops)."""
    words = random_bits(key, shape, device).view(torch.int32).to(torch.int64) & MASK32
    return uniform_of_bits(words, lo, hi)


def key_randint(
    key: Key, shape: tuple[int, ...], minval: int, maxval: int, device=None
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on
    ``device`` (the default device where None).

    As JAX: ``k1, k2 = split(key)``, the high and the low 32-bit words of
    each element drawn under ``k1`` and ``k2``; ``span = maxval - minval``
    as uint32 (1 where ``maxval <= minval``); ``m = ((2^16 mod span)^2)
    mod span``; the element is ``minval + ((hi mod span) * m + (lo mod
    span)) mod span``, every product and sum wrapping at 2^32. On a CUDA
    device both words come from one launch of the threefry kernel's bits
    mode (two segments); on the CPU from :func:`bits_plain`."""
    device = _device(device)
    shape = tuple(int(s) for s in shape)
    minval, maxval = int(minval), int(maxval)
    for name, value in (("minval", minval), ("maxval", maxval)):
        if not -(2**31) <= value < 2**31:
            raise ValueError(f"{name} must be an int32, got {value}")
    count = math.prod(shape)
    k1, k2 = split(key)
    if device.type == "cuda":
        from .ops.threefry_kernel import threefry_segments_cuda

        words = threefry_segments_cuda([k1, k2], [count, count], None, device, normal=False)
        words = words.to(torch.int64) & MASK32
        hi, lo = words[:count], words[count:]
    else:
        _check_cpu(device)
        hi, lo = bits_plain(k1, 0, count, device), bits_plain(k2, 0, count, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (((2**16 % span) ** 2) & MASK32) % span
    offset = (((hi % span) * multiplier) & MASK32) + (lo % span)
    offset = (offset & MASK32) % span
    value = (offset + minval) & MASK32
    return torch.where(value >= 2**31, value - 2**32, value).to(torch.int32).reshape(shape)


def normal(key: Key, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: standard normals on
    ``device`` (the default device where None; the threefry kernel on a
    CUDA device)."""
    device = _device(device)
    shape = tuple(int(s) for s in shape)
    if device.type == "cuda":
        from .ops.threefry_kernel import threefry_normal_cuda

        return threefry_normal_cuda(key, shape, device)
    _check_cpu(device)
    return normal_of_bits(bits_plain(key, 0, math.prod(shape), device)).reshape(shape)


def normals_plain(keys, counts, scales, device, starts=None, runs=None,
                  pitches=None) -> torch.Tensor:
    """The plain version of the segmented threefry kernel: ``normal(keys[s],
    (counts[s],)) * scales[s]`` (no multiply where ``scales`` is None) for
    every ``s``, each from counter ``starts[s]`` (0 where None), in runs of
    ``runs[s]`` counters ``pitches[s]`` apart (one run where None),
    concatenated into one flat float32 tensor."""
    parts = [torch.empty(0, dtype=torch.float32, device=device)]
    for s, (key, count) in enumerate(zip(keys, counts)):
        start = 0 if starts is None else int(starts[s])
        run, pitch = check_span(
            int(count), None if runs is None else runs[s], None if pitches is None else pitches[s]
        )
        part = normal_of_bits(bits_plain(key, start, int(count), device, run, pitch))
        if scales is not None:
            part = part * torch.tensor(scales[s], dtype=torch.float32, device=device)
        parts.append(part)
    return torch.cat(parts)


def normals(
    keys: list[Key],
    shapes: list[tuple[int, ...]],
    scales=None,
    device=None,
    starts=None,
    runs=None,
    pitches=None,
) -> torch.Tensor:
    """``jax.random.normal(keys[s], shapes[s], float32) * scales[s]`` for
    every ``s`` (float32 scales; none where ``scales`` is None), flattened
    and concatenated into one float32 tensor on ``device`` (the default
    device where None): on a CUDA device one launch of the threefry kernel
    for all of them. ``starts[s]`` (the counter base) makes draw ``s`` the
    elements ``[starts[s], starts[s] + prod(shapes[s]))`` of a larger
    draw under its key: a rank's batch rows of ``normal(key, (B, ...))``
    start at ``b0 * prod(...)``. ``runs[s]`` and ``pitches[s]`` make it a
    strided region of that draw, element ``n`` its element ``starts[s] +
    (n // runs[s]) * pitches[s] + n % runs[s]`` (a rank's J slab:
    :func:`slab_span`)."""
    device = _device(device)
    counts = [math.prod(int(n) for n in shape) for shape in shapes]
    for name, values in (("scales", scales), ("starts", starts), ("runs", runs),
                         ("pitches", pitches)):
        if values is not None and len(values) != len(keys):
            raise ValueError(f"{len(keys)} keys and {len(values)} {name}")
    if device.type == "cuda":
        from .ops.threefry_kernel import threefry_segments_cuda

        return threefry_segments_cuda(keys, counts, scales, device, starts=starts, runs=runs,
                                      pitches=pitches)
    _check_cpu(device)
    return normals_plain(keys, counts, scales, device, starts, runs, pitches)


def region_normals(keys: list[Key], region, scales=None) -> torch.Tensor:
    """Each key's ``normal(key, region.shape)`` at the elements of
    ``region`` (a :class:`~.parallel.mesh.Region` of a (B, C, I, J, K)
    tensor) and no other: along B and J one strided segment a key
    (:func:`slab_span`), all of them in one :func:`normals` call (one
    launch on a card), concatenated flat. A region split along C, I or K
    (``Region.splits_c_i_or_k``) is no strided segment: each key's whole
    draw is made and cut to the region."""
    local = region.local
    if region.splits_c_i_or_k:
        n = len(keys)
        whole = normals(keys, [region.shape] * n, scales, local.device)
        box = (slice(None), *(slice(s, s + int(w)) for s, w in zip(region.starts, local.shape)))
        return whole.reshape(n, *region.shape)[box].reshape(-1)
    start, count, run, pitch = slab_span(
        region.shape, region.b0, int(local.shape[0]), region.j0, int(local.shape[3])
    )
    if count == 0:  # a rank that holds no rows or no columns draws nothing
        return torch.empty(0, dtype=torch.float32, device=local.device)
    n = len(keys)
    return normals(keys, [(count,)] * n, scales, local.device, starts=[start] * n,
                   runs=[run] * n, pitches=[pitch] * n)


def _check_cpu(device: torch.device) -> None:
    if device.type != "cpu":
        raise ValueError(f"device draws run on cuda or cpu, got {device}")


def draw_key(seed: int, index: int) -> Key:
    """The JAX package's key of draw ``index`` of a recorded ``seed``:
    index 0 is ``PRNGKey(seed)`` (BiasField); Noise's image ``n`` splits
    the key ``n + 1`` times (``key, k1, k2 = split(key, 3)``) and takes
    ``k1`` (index ``2n + 1``) or, for the second Rician field, ``k2``
    (index ``2n + 2``)."""
    key = prng_key(seed)
    if index > 0:
        for _ in range((index - 1) // 2 + 1):
            key, k1, k2 = split(key, 3)
        key = k1 if index % 2 == 1 else k2
    return key


def device_normal(
    seed: int, shape: tuple[int, ...], device: torch.device | str, index: int
) -> torch.Tensor:
    """Standard normal float32 tensor of ``shape`` on ``device``: draw
    ``index`` of the recorded ``seed``, the JAX package's own draw
    (:func:`draw_key`)."""
    return normal(draw_key(seed, index), shape, device)
