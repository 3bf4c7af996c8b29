"""A pool of gloo ranks for the port's multi-process tests, and the jobs
they run (torch and the port only: this module never imports jax).

:class:`RankPool` spawns ``world`` processes that join one gloo group
(a ``file://`` store in a fresh directory, so concurrent test workers
never share a port), each with one CPU thread, and runs named jobs of
:data:`JOBS` on every rank at once. A job that fails or outlives its
timeout on any rank fails the call, and the pool kills its ranks (the
next call starts a new pool): a hung collective fails its test, never
the suite.

Each job takes numpy inputs made by the test from a seed, runs the
port's sharded entry points on the rank's (data, space) mesh and returns
numpy results (whole tensors gathered after the call, local regions, and
the :class:`CollectiveSpy` counts of the call).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import traceback
import warnings

import numpy as np

WORLD = 4
JOB_TIMEOUT = 120.0
INIT_TIMEOUT = 90.0


# --------------------------------------------------------------------------
# The pool (in the pytest process)
# --------------------------------------------------------------------------


class RankPool:
    """``world`` spawned gloo ranks running :data:`JOBS`."""

    def __init__(self, world: int = WORLD) -> None:
        self.world = world
        self._procs: list = []

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="torch_dist_")
        init_file = os.path.join(self._dir, "store")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(
                target=rank_main,
                args=(rank, self.world, init_file, self._tasks[rank], self._results),
                daemon=True,
            )
            for rank in range(self.world)
        ]
        for proc in self._procs:
            proc.start()

    def run(self, name: str, *args, timeout: float = JOB_TIMEOUT) -> list:
        """Run job ``name`` on every rank; its values in rank order."""
        if not self._procs:
            self._start()
        for tasks in self._tasks:
            tasks.put((name, args))
        values: dict[int, object] = {}
        try:
            while len(values) < self.world:
                rank, ok, value = self._results.get(timeout=timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed in {name}:\n{value}")
                values[rank] = value
        except queue.Empty:
            self.close()
            raise TimeoutError(f"{name} did not finish on every rank in {timeout} s") from None
        except BaseException:
            self.close()
            raise
        return [values[r] for r in range(self.world)]

    def close(self) -> None:
        for tasks in getattr(self, "_tasks", []):
            with contextlib.suppress(Exception):
                tasks.put(None)
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        self._procs = []
        if getattr(self, "_dir", None):
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


# --------------------------------------------------------------------------
# A rank
# --------------------------------------------------------------------------


def rank_main(rank: int, world: int, init_file: str, tasks, results) -> None:
    import cpu_warmup  # noqa: F401  (PyTorch 2.13's first exp region, before anything)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{init_file}",
        rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT),
    )
    import torchio_tpu_torch as tt

    tt.set_default_device("cpu")
    try:
        while True:
            job = tasks.get()
            if job is None:
                break
            name, args = job
            try:
                results.put((rank, True, JOBS[name](*args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


_MESHES: dict = {}


def mesh(space: int | None = None):
    """The rank's (data, space) CPU mesh, built once a layout."""
    from torchio_tpu_torch.parallel import make_mesh

    if space not in _MESHES:
        _MESHES[space] = make_mesh("cpu", space=space)
    return _MESHES[space]


class CollectiveSpy:
    """Counts, while active, every gather a rank could make (the
    ``torch.distributed`` all-gathers, the functional collectives DTensor
    gathers with, ``DTensor.full_tensor``/``redistribute``) with the
    elements each one gathers (-1 where the call does not say), every
    ``all_reduce`` and ``broadcast`` with its elements, and the P2P ops of
    each ``batch_isend_irecv`` call."""

    GATHERS = ("all_gather", "all_gather_into_tensor", "all_gather_object", "_all_gather_base",
               "gather")
    FUNCOL = ("all_gather_tensor", "all_gather_tensor_autograd", "all_gather_into_tensor_coalesced")

    def __init__(self) -> None:
        self.gathers: list[str] = []
        self.gather_elements: list[int] = []
        self.reduces: list[int] = []
        self.broadcasts: list[int] = []
        self.p2p: list[int] = []

    @staticmethod
    def _elements(name: str, args, kwargs) -> int:
        """The elements a gather call brings together."""
        if name in ("full_tensor", "redistribute") and args:
            return int(args[0].numel())
        if name == "all_gather":
            tensors = args[0] if args else kwargs.get("tensor_list")
            return sum(int(t.numel()) for t in tensors)
        if name in ("all_gather_into_tensor", "_all_gather_base"):
            out = args[0] if args else kwargs.get("output_tensor")
            return int(out.numel())
        return -1

    def __enter__(self):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import DTensor

        self._saved = []

        def wrap(owner, name, record):
            real = getattr(owner, name)

            def spy(*args, **kwargs):
                record(name, args, kwargs)
                return real(*args, **kwargs)

            self._saved.append((owner, name, real))
            setattr(owner, name, spy)

        def gather(label):
            def record(n, a, k):
                self.gathers.append(label(n))
                self.gather_elements.append(self._elements(n, a, k))
            return record

        for name in self.GATHERS:
            wrap(dist, name, gather(lambda n: n))
        for name in self.FUNCOL:
            wrap(funcol, name, gather(lambda n: f"funcol.{n}"))
        for name in ("full_tensor", "redistribute"):
            wrap(DTensor, name, gather(lambda n: f"DTensor.{n}"))
        wrap(dist, "all_reduce", lambda n, a, k: self.reduces.append(int(a[0].numel())))
        wrap(dist, "broadcast", lambda n, a, k: self.broadcasts.append(int(a[0].numel())))
        wrap(dist, "batch_isend_irecv", lambda n, a, k: self.p2p.append(len(a[0])))
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)

    @property
    def counts(self) -> dict:
        return {
            "gathers": list(self.gathers),
            "gather_elements": list(self.gather_elements),
            "all_reduce": list(self.reduces),
            "broadcast": list(self.broadcasts),
            "p2p": list(self.p2p),
        }


def _whole(value):
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    return (value.full_tensor() if is_dtensor(value) else value).detach().cpu().numpy()


def _local(value):
    return value.to_local().detach().cpu().numpy()


def _placements(value) -> list[str]:
    return [repr(p) for p in value.placements]


# --------------------------------------------------------------------------
# Jobs
# --------------------------------------------------------------------------


def job_mesh(space):
    import torch.distributed as dist

    m = mesh(space)
    return {
        "shape": tuple(m.shape),
        "names": tuple(m.mesh_dim_names),
        "device_type": m.device_type,
        "coordinate": tuple(m.get_coordinate()),
        "rank": dist.get_rank(),
    }


def job_mesh_indivisible(space):
    from torchio_tpu_torch.parallel import make_mesh

    try:
        make_mesh("cpu", space=space)
    except ValueError as error:
        return str(error)
    return None


def job_step(data, rotations, shifts, seed, space):
    import torch

    from torchio_tpu_torch.parallel import make_augment_step, shard_batch
    from torchio_tpu_torch.parallel.step import augment_step

    m = mesh(space)
    sharded = shard_batch(data, m)
    step = make_augment_step(m)
    with CollectiveSpy() as spy:
        out = step(sharded, rotations, shifts, seed)
    return {
        "out": _whole(out),
        "placements": _placements(out),
        "local_shape": tuple(out.to_local().shape),
        "unsharded": augment_step(torch.as_tensor(data), rotations, shifts, seed, 0.3, 0.05)
        .numpy(),
        "spy": spy.counts,
    }


def job_halo_blur(data, sigma, space):
    from torchio_tpu_torch.parallel import halo_blur, shard_batch

    m = mesh(space)
    sharded = shard_batch(data, m)
    with CollectiveSpy() as spy:
        out = halo_blur(sharded, sigma, m)
    return {"out": _whole(out), "placements": _placements(out), "spy": spy.counts}


def job_halo_affine(data, matrix, space, mode="linear"):
    from torchio_tpu_torch.parallel import halo_resample_affine, shard_batch

    m = mesh(space)
    try:
        with CollectiveSpy() as spy:
            out = halo_resample_affine(shard_batch(data, m), matrix, m, mode=mode)
    except ValueError as error:
        return {"error": f"{type(error).__name__}: {error}"}
    return {"out": _whole(out), "spy": spy.counts}


def _spec_sharding(m, spec):
    from torchio_tpu_torch.parallel.mesh import NamedSharding

    return NamedSharding(m, tuple(spec))


def job_halo_spec(data, matrices, cps, spec, fill, space, mode="linear"):
    from torchio_tpu_torch.parallel.halo import halo_resample_spec
    from torchio_tpu_torch.parallel.mesh import place

    m = mesh(space)
    sharding = "cpu" if spec == "cpu" else _spec_sharding(m, spec)
    import torch

    x = torch.as_tensor(data)
    if not isinstance(sharding, str) and sharding.padded()[3] is not None:
        try:
            x = place(x, sharding)
        except Exception:  # an indivisible shape still reaches the guards
            pass
    try:
        with CollectiveSpy() as spy:
            out = halo_resample_spec(x, matrices, cps, sharding=sharding, mode=mode, fill=fill)
    except ValueError as error:
        return {"error": f"{type(error).__name__}: {error}"}
    return {"out": _whole(out), "placements": _placements(out), "spy": spy.counts}


def _subjects_batch(images: dict, classes: dict, affines=None):
    """A port SubjectsBatch from {name: (B, C, I, J, K) array}."""
    import torchio_tpu_torch as tt

    b = next(iter(images.values())).shape[0]
    subjects = []
    for e in range(b):
        kwargs = {}
        for name, arr in images.items():
            cls = tt.LabelMap if classes.get(name) == "label" else tt.ScalarImage
            aff = None if affines is None else affines[e]
            kwargs[name] = cls(arr[e], affine=aff) if aff is not None else cls(arr[e])
        subjects.append(tt.Subject(**kwargs))
    return tt.SubjectsBatch.from_subjects(subjects)


def pipeline(recipe: str):
    """The port's pipeline of a recipe name (the tests build the JAX
    package's from the same name)."""
    import torchio_tpu_torch as tt

    if recipe == "public":
        return tt.Compose([
            tt.Affine(degrees=(-10.0, 10.0), scales=(0.95, 1.05)),
            tt.BiasField(std=0.4),
            tt.Noise(std=0.05),
            tt.RescaleIntensity(out_min=0.0, out_max=1.0),
        ])
    if recipe == "headline-blur":
        return tt.Compose([
            tt.Spatial(degrees=(-10.0, 10.0), max_displacement=2.0, num_control_points=5),
            tt.BiasField(std=0.4),
            tt.Noise(std=0.05),
            tt.Blur(std=(0.5, 1.5)),
        ], fuse=True)
    if recipe == "blur-shared":
        return tt.Blur(std=(1.0, 1.5), per_instance=False)
    if recipe == "spatial":
        return tt.Spatial(degrees=(-10.0, 10.0), max_displacement=2.0, num_control_points=5)
    if recipe == "spatial-wide":
        return tt.Spatial(degrees=(25.0, 25.0), translation=(20.0, 20.0))
    if recipe == "resample":
        return tt.Resample(target=1.0)
    if recipe == "label-affine":
        return tt.Affine(degrees=(-8.0, 8.0), label_interpolation="label")
    if recipe == "noise":
        return tt.Noise(std=0.1)
    if recipe == "lambda":
        return tt.Lambda(lambda x: 2.0 * x)
    raise KeyError(recipe)


def job_public(recipe, images, classes, seed, spatial, space, affines=None):
    """``batch.shard_(mesh, spatial=...)`` then the recipe's pipeline."""
    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel import halo as halo_mod
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    m = mesh(space)
    batch = _subjects_batch(images, classes, affines).shard_(m, spatial=spatial)
    calls = []
    real = halo_mod.halo_resample_spec

    def spy_spec(*args, **kwargs):
        calls.append(kwargs.get("mode"))
        return real(*args, **kwargs)

    halo_mod.halo_resample_spec = spy_spec
    tt.seed(seed)
    try:
        with warnings.catch_warnings(record=True) as caught, CollectiveSpy() as spy:
            warnings.simplefilter("always")
            out = pipeline(recipe)(batch)
    finally:
        halo_mod.halo_resample_spec = real
    return {
        "images": {n: _whole(ib.data) for n, ib in out.images.items()},
        "sharded": {n: is_dtensor(ib.data) and ib.sharding is not None
                    for n, ib in out.images.items()},
        "placements": {n: _placements(ib.data) for n, ib in out.images.items()
                       if is_dtensor(ib.data)},
        "halo_calls": calls,
        "warnings": [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)],
        "history": [t.name for t in out.applied_transforms],
        "spy": spy.counts,
    }


def job_copy_unshard(images, space):
    """Deep copy, a copying transform and unshard on a sharded batch."""
    import copy

    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    m = mesh(space)
    tt.seed(0)
    batch = _subjects_batch(images, {}).shard_(m)
    dup = copy.deepcopy(batch)
    out = tt.Noise(std=0.1)(dup)
    whole_before = _whole(batch.images["t1"].data)
    items = [np.asarray(img.data.numpy()) for img in batch.images["t1"].unbatch()]
    result = {
        "dup_sharded": dup.images["t1"].sharding is not None,
        "out_sharded": out.images["t1"].sharding is not None and is_dtensor(out.images["t1"].data),
        "out_placements": _placements(out.images["t1"].data),
        "unbatched_equal": bool(np.array_equal(np.stack(items), whole_before)),
    }
    batch.unshard_()
    result["unsharded"] = batch.images["t1"].sharding is None
    result["plain_after"] = not is_dtensor(batch.images["t1"].data)
    return result


def job_shard_drop(data):
    """``shard_`` with an explicit 1-D NamedSharding, then a batch-size
    change (tests/test_batch.py's shard/drop)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from torchio_tpu_torch.data.batch import ImagesBatch
    from torchio_tpu_torch.core.affine import AffineMatrix
    from torchio_tpu_torch.parallel.mesh import NamedSharding, is_dtensor

    m = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    sharding = NamedSharding(m, ("data",))
    batch = ImagesBatch(torch.as_tensor(data), [AffineMatrix() for _ in range(data.shape[0])])
    batch.shard_(sharding)
    placed = _placements(batch.data), tuple(batch.data.to_local().shape)
    batch.data = np.ones((3, 1, 4, 4, 4), np.float32)
    return {
        "placed": placed,
        "dropped": batch.sharding is None and not is_dtensor(batch.data),
        "shape": tuple(batch.data.shape),
    }


def job_blur_axes(data, sigmas, space):
    """``sharded_spatial_axes`` and ``gaussian_blur`` on a J-sharded DTensor."""
    from torchio_tpu_torch.ops.gaussian import gaussian_blur, sharded_spatial_axes
    from torchio_tpu_torch.parallel.mesh import batch_sharding, place

    import torch

    m = mesh(space)
    x = place(torch.as_tensor(data), batch_sharding(m))
    with CollectiveSpy() as spy:
        out = gaussian_blur(x, sigmas)
    return {
        "axes": sharded_spatial_axes(x),
        "plain_axes": sharded_spatial_axes(torch.as_tensor(data)),
        "out": _whole(out),
        "spy": spy.counts,
    }


def _model(name):
    import torch

    if name is None:
        return None
    if name == "affine":
        return lambda x: 2.0 * x + 1.0
    if name == "conv":
        torch.manual_seed(0)
        conv = torch.nn.Conv3d(1, 1, 3, padding=1)
        return lambda x: conv(x).detach()
    raise KeyError(name)


def job_grid_inference(volume, patch_size, overlap, mode, model, space):
    import torch

    from torchio_tpu_torch.parallel import sharded_grid_inference
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place

    m = mesh(space)
    sharding = NamedSharding(m, (None, None, None, "space", None))
    x = torch.as_tensor(volume)
    if volume.shape[3] % m.size(1) == 0:
        x = place(x, sharding)
    try:
        with CollectiveSpy() as spy:
            out = sharded_grid_inference(
                x, mesh=m, model_fn=_model(model), patch_size=patch_size,
                patch_overlap=overlap, overlap_mode=mode,
            )
    except ValueError as error:
        return {"error": f"{type(error).__name__}: {error}"}
    return {
        "out": _whole(out),
        "placements": _placements(out),
        "local_shape": tuple(out.to_local().shape),
        "spy": spy.counts,
    }


def job_large(src, dst, matrix, sigma, space):
    from torchio_tpu_torch.parallel import process_large_volume

    m = mesh(space)
    with CollectiveSpy() as spy:
        out = process_large_volume(src, dst, mesh=m, matrix=matrix, sigma=sigma)
    return {
        "placements": _placements(out),
        "local_shape": tuple(out.to_local().shape),
        "spy": spy.counts,
    }


def job_lazy_read(src, space):
    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel import shard_volume_from_file

    m = mesh(space)
    img = tt.ScalarImage(src)
    seen = []
    cls = type(img)
    real = cls.__getitem__

    def spy(self, index):
        if not isinstance(index, str):
            seen.append(index)
        return real(self, index)

    cls.__getitem__ = spy
    try:
        arr = shard_volume_from_file(img, m)
    except ValueError as error:
        return {"error": f"{type(error).__name__}: {error}"}
    finally:
        cls.__getitem__ = real
    return {
        "widths": [(i[2].stop - i[2].start) for i in seen],
        "loaded": img.is_loaded,
        "whole": _whole(arr),
        "local_shape": tuple(arr.to_local().shape),
    }


def job_write(data, dst, space):
    from torchio_tpu_torch.parallel import write_volume_sharded
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place

    import torch

    m = mesh(space)
    x = place(torch.as_tensor(data), NamedSharding(m, (None, None, None, "space", None)))
    write_volume_sharded(dst, x)
    return tuple(x.to_local().shape)


def job_sampler_defaults(n):
    from torchio_tpu_torch.parallel import DistributedSubjectSampler

    s = DistributedSubjectSampler(n, shuffle=False)
    return {"rank": s.rank, "world": s.world_size, "order": list(s)}


def job_normals(keys, shapes, starts):
    """The counter base on a rank: its rows of a draw."""
    from torchio_tpu_torch import random as tr

    return tr.normals(keys, shapes, None, "cpu", starts=starts).numpy()


def local_recipe(pkg, recipe: str) -> list:
    """The transforms of a pointwise-stage recipe in ``pkg`` (this port or
    the JAX package: the tests build both from the same name)."""
    recipes = {
        "noise": lambda: [pkg.Noise(std=(0.05, 0.2), p=0.7)],
        "rician": lambda: [pkg.Noise(std=(0.05, 0.1), rician=True, p=0.7)],
        "bias": lambda: [pkg.BiasField(std=(0.2, 0.5), p=0.7)],
        "bias-shared": lambda: [pkg.BiasField(std=0.3, per_instance=False)],
        "bias-noise": lambda: [pkg.BiasField(std=0.4), pkg.Noise(std=0.05)],
        "gamma": lambda: [pkg.Gamma(log_gamma=(-0.3, 0.3), p=0.7)],
        "clamp": lambda: [pkg.Clamp(out_min=0.2, out_max=0.8)],
        "flip": lambda: [pkg.Flip(axes=(0, 1, 2), flip_probability=0.5, p=0.8)],
        "flip-shared": lambda: [pkg.Flip(axes=(1, 2), per_instance=False)],
        "znorm": lambda: [pkg.ZNormalization()],
        "znorm-seg": lambda: [pkg.Clamp(out_min=0.1), pkg.ZNormalization(masking_method="seg")],
        "mask": lambda: [pkg.Mask(masking_method="seg", labels=[1, 2], outside_value=-1.0)],
        "rescale": lambda: [pkg.Noise(std=0.05), pkg.RescaleIntensity(out_min=0.0, out_max=1.0)],
        "rescale-pct": lambda: [
            pkg.RescaleIntensity(out_min=(0.0, 0.2), out_max=1.0, percentile_low=1.0,
                                 percentile_high=99.0)
        ],
        "rescale-seg": lambda: [
            pkg.RescaleIntensity(out_min=0.0, out_max=1.0, masking_method="seg",
                                 percentile_low=2.0, percentile_high=98.0)
        ],
        "fill-mean": lambda: [pkg.Spatial(degrees=(-6.0, 6.0), default_pad_value="mean")],
        "fill-otsu": lambda: [pkg.Spatial(degrees=(-6.0, 6.0), default_pad_value="otsu")],
    }
    return recipes[recipe]()


def _history(batch) -> list:
    return [(h.name, h.params, h.include, h.exclude) for h in batch.applied_transforms]


def job_local(recipe, images, classes, seed):
    """``recipe`` fused and unfused, on this rank's whole batch and on the
    batch sharded over B and over B and J: each run's whole images, its
    history, the next host draw and its collectives."""
    import copy

    import torchio_tpu_torch as tt

    m = mesh(None)
    base = _subjects_batch(images, classes)
    out = {}
    for fuse in (False, True):
        for layout in (None, "B", "BJ"):
            batch = copy.deepcopy(base)
            if layout is not None:
                batch.shard_(m, spatial=layout == "BJ")
            pipeline = tt.Compose(local_recipe(tt, recipe), fuse=fuse)
            tt.seed(seed)
            with warnings.catch_warnings(record=True) as caught, CollectiveSpy() as spy:
                warnings.simplefilter("always")
                result = pipeline(batch)
            out[(fuse, layout)] = {
                "images": {n: _whole(ib.data) for n, ib in result.images.items()},
                "sharded": {n: ib.sharding is not None for n, ib in result.images.items()},
                "history": _history(result),
                "draw": float(tt.random.random()),
                "warnings": [str(w.message) for w in caught],
                "spy": spy.counts,
            }
    return out


def job_fills(images, kind, spatial):
    """``_batch_fill_value``'s "mean"/"otsu" fills of a sharded batch
    against the whole batch's, with the collectives of the sharded call."""
    from torchio_tpu_torch.transforms.spatial.spatial import _batch_fill_value

    m = mesh(None)
    whole = _subjects_batch(images, {})
    sharded = _subjects_batch(images, {}).shard_(m, spatial=spatial)
    with CollectiveSpy() as spy:
        got = _batch_fill_value(sharded.images["t1"], default_pad_value=kind,
                                default_pad_label=0.0)
    want = _batch_fill_value(whole.images["t1"], default_pad_value=kind, default_pad_label=0.0)
    return {"got": _whole(got), "local": _local(got), "want": np.asarray(want),
            "spy": spy.counts}


def job_region_draws(key, shape, spatial):
    """A rank's region of a draw through ``random.region_normals``, and
    Noise's field on a sharded tensor."""
    import torch

    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.parallel.mesh import batch_sharding, place, region_of

    m = mesh(None)
    sharding = batch_sharding(m)
    if not spatial:
        from torchio_tpu_torch.parallel.mesh import NamedSharding

        sharding = NamedSharding(m, ("data",))
    x = place(torch.zeros(shape), sharding)
    region = region_of(x)
    with CollectiveSpy() as spy:
        got = tr.region_normals([key], region).reshape(region.local.shape)
    whole = tr.normal(key, shape, "cpu")
    return {
        "equal": bool(torch.equal(got, whole[region.rows][:, :, :, region.cols])),
        "starts": region.starts,
        "spy": spy.counts,
    }


def label_recipe(pkg, recipe: str) -> list:
    """The transforms of a label or index stage recipe in ``pkg`` (this
    port or the JAX package)."""
    recipes = {
        "remap": lambda: [pkg.RemapLabels({1: 2, 2: 1})],
        "remove": lambda: [pkg.RemoveLabels([2])],
        "onehot": lambda: [pkg.OneHot()],
        "onehot3": lambda: [pkg.OneHot(num_classes=3)],
        "contour": lambda: [pkg.Contour()],
        "sequential": lambda: [pkg.SequentialLabels()],
        "swap": lambda: [pkg.Swap(patch_size=4, num_iterations=4, p=0.7)],
        "pca": lambda: [pkg.PCA(num_components=2)],
        "resize": lambda: [pkg.Resize((16, 24, 16))],
        "resize-up": lambda: [pkg.Resize((12, 44, 20))],
        "anisotropy": lambda: [pkg.Anisotropy(downsampling=(2.0, 3.0), p=0.7)],
        "anisotropy-j": lambda: [
            pkg.Anisotropy(axes=(1,), downsampling=(2.0, 3.0), per_instance=False)
        ],
        "crop": lambda: [pkg.Crop(cropping=(2, 3, 1))],
        "pad": lambda: [pkg.Pad(padding=(2, 3, 1))],
        "pad-reflect": lambda: [pkg.Pad(padding=(2, 3, 1), padding_mode="reflect")],
        "pad-reflect-wide": lambda: [
            pkg.Pad(padding=(2, 3, 9, 10, 1, 0), padding_mode="reflect")
        ],
        "pad-replicate": lambda: [pkg.Pad(padding=(0, 1, 3, 2, 1, 1), padding_mode="replicate")],
        "pad-circular": lambda: [pkg.Pad(padding=(1, 0, 5, 9, 0, 3), padding_mode="circular")],
        "pad-median": lambda: [pkg.Pad(padding=(1, 1, 2, 3, 0, 0), padding_mode="median")],
        "croporpad": lambda: [pkg.CropOrPad((12, 40, 16))],
        "croporpad-ik": lambda: [pkg.CropOrPad((12, 32, 20))],
        "transpose": lambda: [pkg.Transpose()],
        "reorient": lambda: [pkg.Reorient("LPI")],
        "reorient-move": lambda: [pkg.Reorient("PLI")],
        "reorient-back": lambda: [pkg.Reorient("PLI"), pkg.Reorient("RAS")],
        "resample-space": lambda: [pkg.Resample(target=(1.0, 1.5, 0.75))],
        "labels-chain": lambda: [
            pkg.RemapLabels({3: 1}), pkg.Anisotropy(axes=(1,), downsampling=(1.5, 5.0)),
            pkg.SequentialLabels(), pkg.Contour(), pkg.OneHot(),
        ],
        # the last gathering stages (the synth and k-space test files)
        "labels-to-image": lambda: [pkg.LabelsToImage(label_key="seg")],
        "labels-to-image-shared": lambda: [
            pkg.LabelsToImage(label_key="seg", ignore_background=True, per_instance=False)
        ],
        "histstd": lambda: [pkg.HistogramStandardization(LANDMARKS, include=["t1"])],
        "keep-largest": lambda: [pkg.KeepLargestComponent()],
        "metadata": lambda: [
            pkg.CopyAffine("t1"),
            pkg.ToReferenceSpace(pkg.ScalarImage(np.zeros((1, 8, 16, 8), np.float32),
                                                 affine=np.diag([2.0, 2.0, 2.0, 1.0]))),
            pkg.To(np.float16),
        ],
        "motion": lambda: [pkg.Motion(degrees=5.0, translation=2.0, p=0.7)],
        "ghosting": lambda: [pkg.Ghosting(intensity=(0.3, 0.7), p=0.7)],
        "ghosting-shared": lambda: [pkg.Ghosting(intensity=0.5, axes=(1,), per_instance=False)],
        "spike": lambda: [pkg.Spike(intensity=(1.0, 3.0), p=0.7)],
        "kspace": lambda: [
            pkg.Motion(degrees=5.0, translation=3.0, num_transforms=1, p=0.5),
            pkg.Ghosting(intensity=(0.3, 0.7), p=0.5),
        ],
        # forward stages whose recorded inverses the inverse jobs replay
        "pointwise-inverses": lambda: [
            pkg.Flip(axes=(0, 1, 2), flip_probability=0.5),
            pkg.RescaleIntensity(out_min=(0.0, 0.2), out_max=1.0),
            pkg.ZNormalization(),
            pkg.BiasField(std=(0.2, 0.5), p=0.7),
            pkg.Gamma(log_gamma=(-0.3, 0.3), p=0.7),
            pkg.OneHot(),
        ],
        "shared-inverses": lambda: [
            pkg.Flip(axes=(1,), per_instance=False),
            pkg.RescaleIntensity(out_min=0.0, out_max=1.0, per_instance=False),
            pkg.BiasField(std=0.3, per_instance=False),
            pkg.Gamma(log_gamma=0.2, per_instance=False),
        ],
    }
    return recipes[recipe]()


#: HistogramStandardization's landmarks of the ``histstd`` recipe: one a
#: default quantile, increasing
LANDMARKS = np.asarray([0.0, 4.0, 11.0, 18.0, 24.0, 33.0, 45.0, 52.0, 60.0, 71.0, 77.0, 90.0,
                        100.0], np.float32)


#: the layouts of the label and index stages: (data, space) -> (space,
#: whether J is split)
LABEL_LAYOUTS = {"(4, 1)": (1, False), "(2, 2)": (2, True), "(1, 4)": (4, True)}


def job_labels(recipe, images, classes, seed, inverse=False):
    """``recipe`` on this rank's whole batch and on the batch sharded at
    each of :data:`LABEL_LAYOUTS`: each run's whole images and affines,
    its history, the next host draw, its warnings, how often a stage
    entered ``gathered``, and its collectives. With ``inverse``, the
    recipe's result then goes through ``apply_inverse_transform()``: the
    images are the inverse's, the history the forward's, and the
    collectives the inverse's alone."""
    import copy

    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel.mesh import is_dtensor
    from torchio_tpu_torch.transforms import transform as transform_mod

    base = _subjects_batch(images, classes)
    real = transform_mod.gathered
    entered = []

    def spy_gathered(batch):
        entered.append(type(batch).__name__)
        return real(batch)

    out = {}
    for layout in (None, *LABEL_LAYOUTS):
        batch = copy.deepcopy(base)
        coordinate = None
        if layout is not None:
            space, spatial = LABEL_LAYOUTS[layout]
            batch.shard_(mesh(space), spatial=spatial)
            coordinate = tuple(mesh(space).get_coordinate())
        pipeline = tt.Compose(label_recipe(tt, recipe), fuse=False)
        tt.seed(seed)
        entered.clear()
        transform_mod.gathered = spy_gathered
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with CollectiveSpy() as spy:
                    result = pipeline(batch)
                history = _history(result)
                if inverse:
                    with CollectiveSpy() as spy:
                        result = result.apply_inverse_transform()
        finally:
            transform_mod.gathered = real
        out[layout] = {
            "images": {n: _whole(ib.data) for n, ib in result.images.items()},
            "affines": {n: np.stack([a.data for a in ib.affines])
                        for n, ib in result.images.items()},
            "sharded": {n: ib.sharding is not None and is_dtensor(ib.data)
                        for n, ib in result.images.items()},
            "history": history,
            "draw": float(tt.random.random()),
            "warnings": [str(w.message) for w in caught],
            "gathered": len(entered),
            "coordinate": coordinate,
            "spy": spy.counts,
        }
    return out


def job_composer_placement(images, classes, seed):
    """A per-instance OneOf and SomeOf on a batch sharded over B and J at
    (2, 2): whether each image keeps a sharding (``ImagesBatch.sharding``)
    and a DTensor after the call, and its whole images."""
    import copy

    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    out = {}
    for name in ("OneOf", "SomeOf"):
        batch = _subjects_batch(images, classes).shard_(mesh(2), spatial=True)
        composer = composer_recipe(tt, name)
        tt.seed(seed)
        result = composer(copy.deepcopy(batch))
        out[name] = {
            "sharding": {n: ib.sharding is not None for n, ib in result.images.items()},
            "dtensor": {n: is_dtensor(ib.data) for n, ib in result.images.items()},
            "images": {n: _whole(ib.data) for n, ib in result.images.items()},
        }
    return out


def composer_recipe(pkg, name: str):
    """A per-instance OneOf or SomeOf of pointwise stages in ``pkg``."""
    stages = [pkg.Noise(std=0.1), pkg.Gamma(log_gamma=(-0.3, 0.3)), pkg.Flip(axes=(1,))]
    if name == "OneOf":
        return pkg.OneOf(stages)
    return pkg.SomeOf(stages, num_transforms=(1, 2))


# --------------------------------------------------------------------------
# Splits along C, I and K (tests/test_torch_parallel_splits.py)
# --------------------------------------------------------------------------

#: the layouts that split C, I or K: name -> (space, spec), ``space``
#: the size of the mesh axis "space" of the (WORLD // space, space) mesh
SPLIT_LAYOUTS = {
    "C": (4, (None, "space", None, None, None)),
    "I": (4, (None, None, "space", None, None)),
    "K": (4, (None, None, None, None, "space")),
    "B+I": (2, ("data", None, "space", None, None)),
    "B+K": (2, ("data", None, None, None, "space")),
}


def split_spec(spec, shape, sizes) -> tuple:
    """``spec`` for an image of ``shape``, or ``()`` (replicated) where a
    dim it splits does not divide by its mesh axis's ranks (``sizes``:
    axis name -> ranks): the JAX package places only divisible dims, so a
    one-channel label map beside a C-split image stays whole."""
    for dim, name in enumerate(spec):
        if name is not None and shape[dim] % sizes[name]:
            return ()
    return tuple(spec)


def split_recipe(pkg, recipe: str) -> list:
    """The transforms of a C, I and K split recipe in ``pkg`` (this port
    or the JAX package). Every extent a stage leaves on I and K divides
    by 4, and C stays 4, so the JAX package places each output on the
    spec it was given."""
    recipes = {
        # the regressions: each gave a wrong result or raised on an I, K
        # or C split of more than one rank
        "f1-znorm": lambda: [pkg.ZNormalization()],
        "f1-rescale": lambda: [pkg.RescaleIntensity(out_min=0.0, out_max=1.0)],
        "f1-contour": lambda: [pkg.Contour()],
        "f1-noise": lambda: [pkg.Noise(std=0.1)],
        "f1-resize": lambda: [pkg.Resize((8, 8, 12))],
        # the pointwise stages no other recipe runs unfused
        "pointwise": lambda: [
            pkg.Clamp(out_min=0.05, out_max=1.2),
            pkg.ZNormalization(masking_method="seg"),
            pkg.Mask(masking_method="seg", labels=[1, 2], outside_value=-1.0),
            pkg.Blur(std=(0.5, 1.5)),
        ],
        # every fusable stage, for a fused run
        "pointwise-all": lambda: [
            pkg.Noise(std=(0.05, 0.2), p=0.7),
            pkg.BiasField(std=(0.2, 0.5), p=0.7),
            pkg.Clamp(out_min=0.05, out_max=1.2),
            pkg.Gamma(log_gamma=(-0.3, 0.3), p=0.7),
            pkg.Flip(axes=(0, 1, 2), flip_probability=0.5, p=0.8),
            pkg.RescaleIntensity(out_min=(0.0, 0.2), out_max=1.0, percentile_low=1.0,
                                 percentile_high=99.0),
            pkg.ZNormalization(masking_method="seg"),
            pkg.Mask(masking_method="seg", labels=[1, 2], outside_value=-1.0),
            pkg.Blur(std=(0.5, 1.5)),
        ],
        "spatial": lambda: [
            pkg.Affine(degrees=(-8.0, 8.0), scales=(0.95, 1.05), default_pad_value="mean"),
            pkg.Spatial(degrees=(-6.0, 6.0), max_displacement=2.0, num_control_points=5,
                        default_pad_value="otsu"),
            pkg.Resample(target=(2.0, 1.0, 0.5)),
        ],
        "labels": lambda: [
            pkg.RemapLabels({1: 2, 2: 1}),
            pkg.RemoveLabels([4]),
            pkg.SequentialLabels(),
            pkg.KeepLargestComponent(),
            pkg.Contour(),
            pkg.OneHot(),
        ],
        "index": lambda: [
            pkg.Crop(cropping=(2, 0, 2)),
            pkg.Pad(padding=(2, 1, 2)),
            pkg.Resize((8, 12, 12)),
            pkg.Anisotropy(downsampling=(2.0, 3.0), p=0.7),
            pkg.CropOrPad((12, 10, 16)),
            pkg.EnsureShapeMultiple(8),
            pkg.Reorient("LPI"),
            pkg.Transpose(),
            pkg.Reorient("PLI"),
        ],
        "synth": lambda: [
            pkg.LabelsToImage(label_key="seg", image_key="tissue"),
            pkg.HistogramStandardization(LANDMARKS, include=["t1"]),
            pkg.Swap(patch_size=4, num_iterations=4, p=0.7),
            pkg.PCA(num_components=4, include=["t1"]),
        ],
        "kspace": lambda: [
            pkg.Motion(degrees=5.0, translation=2.0, p=0.7),
            pkg.Ghosting(intensity=(0.3, 0.7), p=0.7),
            pkg.Spike(intensity=(1.0, 3.0), p=0.7),
        ],
        "metadata": lambda: label_recipe(pkg, "metadata"),
        # forward stages whose recorded inverses the inverse runs replay
        "inverses": lambda: [
            *label_recipe(pkg, "pointwise-inverses")[:5],
            pkg.SequentialLabels(),
            pkg.Affine(degrees=(-8.0, 8.0), include=["t1"]),
            pkg.OneHot(),
        ],
    }
    return recipes[recipe]()


def job_splits(recipe, images, classes, seed, layouts, fuse=False, inverse=False):
    """``recipe`` on this rank's whole batch and on the batch with each
    image placed by :func:`split_spec` of each of ``layouts`` (name ->
    (space, spec)): each run's whole images, whether each rank's block
    equals its region of the whole run's, its placements, history, next
    host draw and warnings, the DTensor images of each stage (or fused
    run) that entered ``gathered``, and its collectives. With ``inverse``, the result then
    goes through ``apply_inverse_transform()`` (the images are the
    inverse's, the history the forward's)."""
    import copy

    import torch

    import torchio_tpu_torch as tt
    from torchio_tpu_torch.parallel.mesh import NamedSharding, is_dtensor, local_slices
    from torchio_tpu_torch.transforms import fuse as fuse_mod
    from torchio_tpu_torch.transforms import transform as transform_mod

    base = _subjects_batch(images, classes)
    real = transform_mod.gathered
    entered = []

    def spy_gathered(batch):
        entered.append(sum(is_dtensor(ib.data) for ib in batch.images.values()))
        return real(batch)

    def run(batch):
        pipeline = tt.Compose(split_recipe(tt, recipe), fuse=fuse)
        tt.seed(seed)
        entered.clear()
        transform_mod.gathered = fuse_mod.gathered = spy_gathered
        try:
            with warnings.catch_warnings(record=True) as caught, CollectiveSpy() as spy:
                warnings.simplefilter("always")
                result = pipeline(batch)
                history = _history(result)
                if inverse:
                    result = result.apply_inverse_transform()
        finally:
            transform_mod.gathered = fuse_mod.gathered = real
        return result, {
            "history": history,
            "draw": float(tt.random.random()),
            "warnings": [str(w.message) for w in caught],
            "gathered": list(entered),
            "spy": spy.counts,
        }

    whole, out = run(copy.deepcopy(base))
    wholes = {n: ib.data for n, ib in whole.images.items()}
    out = {None: {**out, "images": {n: d.numpy() for n, d in wholes.items()}}}
    for layout, (space, spec) in layouts.items():
        m = mesh(space)
        sizes = dict(zip(m.mesh_dim_names, m.shape))
        batch = copy.deepcopy(base)
        for ib in batch.images.values():
            ib.shard_(NamedSharding(m, split_spec(spec, ib.data.shape, sizes)))
        result, record = run(batch)
        blocks = {}
        for n, ib in result.images.items():
            if is_dtensor(ib.data) and n in wholes and ib.data.shape == wholes[n].shape:
                region = wholes[n][local_slices(ib.data.shape, ib.sharding)]
                blocks[n] = bool(torch.equal(ib.data.to_local(), region))
        out[layout] = {
            **record,
            "images": {n: _whole(ib.data) for n, ib in result.images.items()},
            "blocks": blocks,
            "placements": {n: _placements(ib.data) if is_dtensor(ib.data) else None
                           for n, ib in result.images.items()},
        }
    return out


def job_split_guards(t1, space, spec):
    """The region code and the placement-taking entries on a tensor placed
    by ``spec`` on the (WORLD // space, space) mesh: what
    ``Region.check_rows`` and the sharded "mean" fill raise, whether the
    region's draws, ``reduce_sum`` and ``reduce_max`` equal the whole
    tensor's, whether ``_batch_fill_value``, the fused step and the
    sharded grid inference on it equal their results on the whole
    tensor, and the
    error of ``halo_resample_spec``."""
    import torch

    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.parallel import make_augment_step, sharded_grid_inference
    from torchio_tpu_torch.parallel.halo import halo_resample_spec
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place, region_of
    from torchio_tpu_torch.transforms.spatial.spatial import (
        _batch_fill_value,
        _sharded_border_fill,
    )

    def error(call) -> str:
        try:
            call()
        except ValueError as caught:
            return f"{type(caught).__name__}: {caught}"
        return ""

    m = mesh(space)
    sharding = NamedSharding(m, tuple(spec))
    whole = torch.as_tensor(t1)
    x = place(whole, sharding)
    region = region_of(x)
    key = tr.prng_key(11)
    drawn = tr.region_normals([key], region).reshape(region.local.shape)
    box = tuple(slice(s, s + int(w)) for s, w in zip(region.starts, region.local.shape))
    batch = _subjects_batch({"t1": t1}, {})
    batch.images["t1"].shard_(sharding)
    fill = _batch_fill_value(batch.images["t1"], default_pad_value="mean", default_pad_label=0)
    plain = _batch_fill_value(_subjects_batch({"t1": t1}, {}).images["t1"],
                              default_pad_value="mean", default_pad_label=0)
    rng = np.random.default_rng(5)
    rotations = np.stack([np.eye(3, dtype=np.float32)] * whole.shape[0])
    shifts = rng.uniform(-0.5, 0.5, (whole.shape[0], 3)).astype(np.float32)
    step = make_augment_step(m)
    placed, given_whole = step(x, rotations, shifts, 7), step(whole, rotations, shifts, 7)
    inference = sharded_grid_inference(x, mesh=m, patch_size=(4, 3, 4), patch_overlap=(2, 0, 2),
                                       overlap_mode="average")
    inference_whole = sharded_grid_inference(whole, mesh=m, patch_size=(4, 3, 4),
                                             patch_overlap=(2, 0, 2), overlap_mode="average")
    return {
        "splits": region.splits_c_i_or_k and batch.stages_take_whole,
        "check_rows": error(region.check_rows),
        "border_fill": error(lambda: _sharded_border_fill(x, sharding, "mean")),
        "draws": bool(torch.equal(drawn, tr.normal(key, tuple(whole.shape), "cpu")[box])),
        "reduce_sum": int(region.reduce_sum(torch.tensor([region.local.numel()]))[0])
        == whole.numel(),
        "reduce_max": float(region.reduce_max(region.local.amax().reshape(1))[0])
        == float(whole.max()),
        "fill": bool(torch.equal(torch.as_tensor(fill), torch.as_tensor(plain))),
        "step": bool(torch.equal(_whole_tensor(placed), _whole_tensor(given_whole))),
        "inference": bool(torch.equal(_whole_tensor(inference), _whole_tensor(inference_whole))),
        "halo": error(lambda: halo_resample_spec(x, [np.eye(4)] * whole.shape[0],
                                                 [None] * whole.shape[0], sharding=sharding)),
    }


def _whole_tensor(value):
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    return value.full_tensor() if is_dtensor(value) else value


JOBS = {
    name[4:]: fn for name, fn in dict(globals()).items() if name.startswith("job_")
}
