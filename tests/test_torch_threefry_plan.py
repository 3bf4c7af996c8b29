"""The segmented threefry draw of ``torchio_tpu_torch``: one launch for a
list of draws.

- :func:`torchio_tpu_torch.random.normals` (the plain version on the CPU)
  equals separate ``normal(key_s, shape_s) * scale_s`` draws bit for bit,
  and ``jax.random.normal`` within 1e-6, on ``chip_smoke.threefry_keys``'
  keys;
- ``ops/threefry_kernel.py::segment_plan``, the host side of
  ``csrc/threefry.cu``'s launch: each segment's offset; the split into
  launches past the table's cap; and the ten injected key words, which,
  run through the kernel's rounds (written out here), give
  ``jax.random.bits``; the kernel's split of a segment into a scalar head
  before the first 16-byte aligned element, its vectors and its tail
  (written out here);
- the draws without a device follow the package's default device;
- BiasField's per-element fields and Noise's Rician pair each go through
  one ``normals`` call (one launch on a card), fused and unfused, and the
  outputs still match the JAX package.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_warmup  # noqa: F401  (warms PyTorch's CPU thread pool at import)

import chip_smoke
import torchio_tpu_torch as tt
from test_torch_intensity import assert_same, make_batches, run_both
from torchio_tpu_torch import random as tr
from torchio_tpu_torch.ops import threefry_kernel as tk

NORMAL_ATOL = 1e-6
KEYS = list(chip_smoke.threefry_keys(tr).values())
SHAPES = [(1,), (3, 5), (2, 0, 3), (7, 11, 13)]
#: 0 and a negative scale; |scale| <= 1 keeps JAX's 1e-6 bound
SCALES = np.asarray([0.5, 0.0, -1.0, 0.75], np.float32)
MASK32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def host_data_on_cpu():
    previous = tt.set_default_device("cpu")
    yield
    tt.set_default_device(previous)


def jax_key(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_normals_equal_separate_draws(scaled):
    scales = SCALES if scaled else None
    got = tr.normals(KEYS, SHAPES, scales, "cpu")
    parts = []
    for s, (key, shape) in enumerate(zip(KEYS, SHAPES)):
        part = tr.normal(key, shape).reshape(-1)
        parts.append(part * torch.tensor(scales[s]) if scaled else part)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.cat(parts))


def test_normals_match_jax_per_segment():
    got = tr.normals(KEYS, SHAPES, SCALES, "cpu").numpy()
    offset = 0
    for key, shape, scale in zip(KEYS, SHAPES, SCALES):
        n = int(np.prod(shape))
        want = np.asarray(jax.random.normal(jax_key(key), shape, jnp.float32) * scale)
        np.testing.assert_allclose(got[offset : offset + n], want.reshape(-1), rtol=0,
                                   atol=NORMAL_ATOL)
        offset += n
    assert offset == got.size


def test_normals_of_no_draws_and_bad_scales():
    assert tr.normals([], [], None, "cpu").shape == (0,)
    with pytest.raises(ValueError, match="scales"):
        tr.normals(KEYS[:2], SHAPES[:2], [1.0], "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tr.normals(KEYS[:1], SHAPES[:1], None, "meta")


def test_plan_offsets():
    """Segments one after the other; empty draws take no segment."""
    counts = [1, 3, 5, 0, 8, 2, 1031, 0, 4]
    (segments,) = tk.segment_plan((KEYS * 3)[: len(counts)], counts, None)
    starts = np.cumsum([0, *counts])[:-1]
    assert [(s.offset, s.count) for s in segments] == [
        (int(o), c) for o, c in zip(starts, counts) if c
    ]
    assert all(seg.scale == 1.0 for seg in segments)


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_unaligned_segments_split_into_head_vectors_tail(shift):
    """``csrc/threefry.cu``'s split of a segment at a 4-byte aligned
    address, ``shift`` elements past a 16-byte boundary: the scalar head
    (``head_of``), the 16-byte vectors of four elements (each starting
    aligned) and the scalar tail cover every element once."""
    vec = 4
    for count in (1, 3, 5, 8, 1031):
        address = 0x7F0000001000 + 4 * shift
        head = min((16 - address % 16) % 16 // 4, count)
        vectors = (count - head) // vec
        body = []
        for v in range(vectors):
            e = head + v * vec
            assert (address + 4 * e) % 16 == 0
            body += range(e, e + vec)
        tail = list(range(head + vectors * vec, count))
        assert len(tail) < vec
        assert list(range(head)) + body + tail == list(range(count))


def test_plan_splits_past_the_cap():
    n = 2 * tk.MAX_SEGMENTS + 1
    keys = tr.split(tr.prng_key(7), n)
    counts = [(i * 37) % 101 + 1 for i in range(n)]
    scales = [float(i - 24) / 8 for i in range(n)]
    launches = tk.segment_plan(keys, counts, scales)
    assert [len(segs) for segs in launches] == [tk.MAX_SEGMENTS, tk.MAX_SEGMENTS, 1]
    flat = [seg for segs in launches for seg in segs]
    assert [seg.key for seg in flat] == keys
    assert [seg.scale for seg in flat] == scales
    assert [seg.offset for seg in flat] == [sum(counts[:i]) for i in range(n)]


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="32-bit words"):
        tk.segment_plan([(2**32, 0)], [3], None)
    with pytest.raises(ValueError, match="one entry a draw"):
        tk.segment_plan(KEYS[:2], [3], None)


def kernel_word(seg: tk.Segment, e: int) -> int:
    """``csrc/threefry.cu``'s word_of for element ``e`` of ``seg``, from
    the plan's key and injected words alone."""
    x0 = ((e >> 32) + seg.key[0]) & MASK32
    x1 = ((e & MASK32) + seg.key[1]) & MASK32
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    for g in range(5):
        for r in rotations[g % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + seg.inject[2 * g]) & MASK32
        x1 = (x1 + seg.inject[2 * g + 1]) & MASK32
    return x0 ^ x1


@pytest.mark.parametrize("index", range(len(KEYS)))
def test_plan_injections_give_jax_bits(index):
    key = KEYS[index]
    (segments,) = tk.segment_plan([key], [70001], None)
    want = np.asarray(jax.random.bits(jax_key(key), (70001,)))
    for e in (0, 1, 2, 3, 1000, 65535, 65536, 70000):
        assert kernel_word(segments[0], e) == int(want[e])
    assert segments[0].inject == tr.key_injections(key)


def test_injections_past_the_counters_low_word():
    """The high counter word enters x0 as the kernel's 64-bit path adds
    it: element 2^32 + 10 of a draw."""
    (segments,) = tk.segment_plan([KEYS[0]], [5], None)
    want = int(tr.bits_plain(KEYS[0], 2**32 + 10, 1, "cpu")[0])
    assert kernel_word(segments[0], 2**32 + 10) == want


@pytest.fixture
def spy(monkeypatch):
    """Records every call of ``random.normals`` (one launch on a card)."""
    calls = []
    real = tr.normals

    def normals(keys, shapes, scales=None, device=None):
        calls.append((list(keys), [tuple(s) for s in shapes], scales))
        return real(keys, shapes, scales, device)

    monkeypatch.setattr(tr, "normals", normals)
    return calls


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_bias_per_element_draws_all_fields_at_once(spy, fuse):
    jax_batch, port_batch = make_batches(b=3, shape=(2, 14, 16, 18))
    jax_out, port_out = run_both(
        lambda pkg: pkg.BiasField(std=(0.2, 0.8)), jax_batch, port_batch, fuse=fuse
    )
    assert len(spy) == 1
    keys, shapes, scales = spy[0]
    params = port_out.applied_transforms[0].params
    assert keys == [tr.prng_key(sd) for sd in params["seed"]]
    assert shapes == [(1, 2, 4, 4, 4)] * 3
    np.testing.assert_array_equal(scales, np.asarray(params["std"], np.float32))
    assert_same(jax_out, port_out)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_rician_pair_is_one_draw(spy, fuse):
    jax_batch, port_batch = make_batches(names=("t1", "t2"))
    jax_out, port_out = run_both(
        lambda pkg: pkg.Noise(std=(0.05, 0.2), rician=True), jax_batch, port_batch, fuse=fuse
    )
    seed = port_out.applied_transforms[0].params["seed"]
    assert [keys for keys, _, _ in spy] == [
        [tr.draw_key(seed, 2 * n + 1), tr.draw_key(seed, 2 * n + 2)] for n in range(2)
    ]
    assert all(scales is None for _, _, scales in spy)
    assert_same(jax_out, port_out, names=("t1", "t2"))


def test_gaussian_noise_and_shared_bias_stay_single_draws(spy):
    _, batch = make_batches()
    tt.seed(4)
    tt.Compose([tt.BiasField(per_instance=False), tt.Noise(std=0.1)], fuse=True)(batch)
    assert spy == []


def test_segmented_wrapper_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        tk.threefry_segments_cuda(KEYS[:2], [3, 4], [1.0, 2.0], "cpu")
    with pytest.raises(ValueError, match="no scale"):
        tk.threefry_segments_cuda(KEYS[:1], [3], [2.0], "cuda", normal=False)


@pytest.mark.parametrize(
    "draw, wrapper",
    [
        (lambda: tr.normals(KEYS[:2], [(3,), (4,)], [1.0, 2.0]), "threefry_segments_cuda"),
        (lambda: tr.normal(KEYS[0], (3,)), "threefry_normal_cuda"),
        (lambda: tr.random_bits(KEYS[0], (3,)), "threefry_bits_cuda"),
        (lambda: tr.key_uniform(KEYS[0], (3,), -1.0, 1.0), "threefry_bits_cuda"),
    ],
    ids=["normals", "normal", "random_bits", "key_uniform"],
)
def test_draws_without_a_device_follow_the_default(monkeypatch, draw, wrapper):
    """No device: the package's default device (``cuda`` unless set), as
    host data; here the CUDA wrapper is replaced by a recorder."""
    assert draw().device.type == "cpu"
    devices = []

    def record(*args, **kwargs):
        devices.append(torch.device(args[3] if wrapper == "threefry_segments_cuda" else args[2]))
        raise RuntimeError("recorded")

    monkeypatch.setattr(tk, wrapper, record)
    tt.set_default_device("cuda")
    with pytest.raises(RuntimeError, match="recorded"):
        draw()
    assert devices == [torch.device("cuda")]
