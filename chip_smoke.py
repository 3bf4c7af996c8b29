#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``torchio_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: requires CUDA; prints the card's name and power limit, and
   the torch, CUDA, nvcc and Triton versions;
2. build: compiles every kernel library from ``torchio_tpu_torch/csrc``,
   one ``nvcc`` per source, all at once, and beside them the host decode
   library ``torchio_tpu_torch/native/fastnifti.cpp`` (g++, zlib: gunzip,
   the layout transform, the JPEG Lossless and JPEG-LS decoders); fails
   if either does not build;
3. kernels against their plain PyTorch versions on the card:
   - resample: linear within 1e-5 max abs on inputs in [0, 1); nearest
     equal away from .5 ties; also on the row tiling's edges (rows of 1,
     3, 5 and 1,100 voxels, io x b and j tiles past the 65,535 grid cap),
     a field too fine to stage in shared memory, and a 1,291^3 volume
     (8.6 GB: offsets past 2^31);
   - label vote: equal off near ties, on int32 labels (also above 2^24),
     float32 labels, labels in large blocks and drawn per voxel, and
     tie-heavy half-voxel shifts; also on the row tiling's edges, a field
     too fine to stage, and a 1,291^3 int32 volume (offsets past 2^31);
   - prefilter: within 1e-5 of the plain coefficients' largest magnitude,
     orders 2-7, on lines that do not fill the last block, lines of 2,100
     samples on each axis (shared memory) and of 7,300 (device memory),
     and on 2-4 channels, which must come out channels-last;
   - spline: within 1e-5 max abs for orders 2-7 on inputs in [0, 1), on
     2 and 4 channels (four a load), from planar coefficients and from
     the prefilter kernel's channels-last ones, scale-downs by 2.6 and 4
     included;
   - dense-coordinate resample: equal, linear and nearest, shared and
     per-element grids, every fill form, points outside the volume, a
     size-1 axis, and the grid-spec resample's tiling edges and 1,291^3
     volume;
   - dense-coordinate spline: within 1e-5 max abs for orders 2-7, on 1, 2
     and 4 channels, shared and per-element grids, the row tiling's edges
     and a 1,291^3 volume (offsets past 2^31);
   - threefry (jax.random's draws): the kernel's 32-bit words equal to
     the plain version's on draws that do not fill the last block, a
     4 x 256^3 draw, keys from split, and a draw past 2^32 words (the
     counter's high word); its normals within 1e-6 (log1pf rounds
     differently on the card), with the share of exact matches; its
     segmented draws (one launch for a list of draws: one segment,
     BiasField's 4 fields of 216 and of 576 normals times scales with 0
     and a negative one, segments of 1, 3 and 5 at unaligned offsets,
     cap + 1 segments in two launches, a Rician pair at 4 x 256^3) with
     words equal to the plain version's and normals equal to the kernel's
     separate draws times their scales;
4. small batches on the card against the CPU path, the card drawing its
   noise and bias fields with the threefry kernel and the CPU with the
   plain version: the headline (1e-4), the labelled BraTS-style pipeline
   (images 1e-4, labels equal off near ties), the k-space pair (1e-4,
   labels untouched), config 1 and config 2 (1e-4), config 3 (2 x (4 +
   1) x 40x44x24 at 1x1x2 mm to 1 mm) and config 4's forward and inverse
   (2 x (1 + 1) x 40x44x48; images 1e-4, labels equal off near ties of
   any step, 4 resample launches each); the patch layer: config 5's Queue
   (2 x 48^3 t1 + int32 seg, LabelSampler 16^3, Motion + Ghosting,
   ``device_batches``; images 1e-4, labels, locations and affines equal,
   one dense resample launch a subject that kept Motion), a GridSampler
   -> PatchAggregator pass in each mode (1e-6), Spike (1e-4), and
   ``key_randint``'s words (equal, one threefry bits launch a draw), the
   Label and Weighted samplers' corners on non-dyadic weights (equal: the
   CDF is summed in XLA:CPU's order, ``sampler.xla_cumsum``) and a 256^3
   CDF (bit-equal); the new paths below at a small size: policy-someof
   (4 x (1 + 1) x 40x44x48, forward and per-element inverse; images 1e-4,
   labels equal off near ties of each element's Spatial step and of its
   inverse, per-element histories equal, launches as the draws imply),
   kspace-oneof (4 x 40x44x48; 1e-4, labels untouched, one dense resample
   launch a Motion move) and brats-preprocess-fused (2 x (4 + 1) x
   50x52x48; 1e-4, fused equal to unfused on the card, no kernel launch);
   every module of the rest of the zoo (Transpose, CopyAffine,
   Reorient, ToReferenceSpace, Resize, Anisotropy, Swap, the label tools,
   PCA, HistogramStandardization, LabelsToImage, Lambda, To) on 2 x (1 +
   3 + 1) x 24x28x32 (equal for the index and label transforms, else
   1e-5; histories, the next host draw and the launches equal; Anisotropy
   and Swap with the first element gated out), synthseg-labels-to-image
   on 2 x 32x36x28 with a whole-voxel Spatial (1e-4, seg equal) and
   ixi-preprocess-histstd on 2 x 40x44x24 (1e-4, one-hot equal off near
   ties of its Resample); int16, uint16 and uint32 images through Flip,
   Reorient, Swap, RemapLabels (equal), Resize, Anisotropy, Blur, Motion,
   Ghosting and Spike (within 1 + 1e-5 of the largest magnitude), their
   dtypes kept; NIfTI files of every dtype ``write_nifti`` writes, as
   ``.nii`` and ``.nii.gz``, loaded on the card equal to the CPU's load,
   and a lazy CropOrPad (crop and constant pad as views, and a reflect
   pad) of subjects read from files equal to the eager one on the card;
   a subject and an array built from numpy go through the headline on the
   card (host data lands there by default) and launch the resample
   kernel;
5. headline: ``Compose([Spatial, BiasField, Noise], fuse=True)`` on
   B=4 x 1 x 256^3 float32 through ``Compose.__call__``, 2 warm-up and 5
   timed calls, with the launch counts read around the run;
6. brats-label-bspline: ``Compose([Spatial(image_interpolation="bspline",
   label_interpolation="label"), BiasField, Noise], fuse=True)`` on B=4
   subjects of a 4-channel 240x240x155 float32 ``mri`` and a 1-channel
   int32 ``seg`` (labels {0, 1, 2, 4}), the same way;
7. kspace-motion-ghosting: ``Compose([Motion(degrees=5, translation=3,
   num_transforms=1, p=0.5), Ghosting(intensity=(0.3, 0.7), p=0.5)])``
   on B=4 subjects of a 256^3 float32 ``t1`` and an int32 ``seg``, the
   same way; the dense resample kernel must launch in exactly the calls
   whose history keeps Motion;
8. config1-flip-noise-rescale: BASELINE.json config 1,
   ``Compose([Flip(axes=(0,), flip_probability=0.5), Noise(std=0.1),
   RescaleIntensity(0, 1)], fuse=True)`` on B=4 x 1 x 181x217x181
   float32, the same way; the output must lie in [0, 1];
9. config2-blur-bias-gamma: BASELINE.json config 2, ``Compose([Blur(
   std=(0.5, 1.5)), BiasField(std=0.5), Gamma(log_gamma=(-0.3, 0.3))])``
   (unfused) on B=4 x 1 x 256^3 float32, the same way; every path must
   launch the threefry kernel THREEFRY_LAUNCHES times a call (BiasField's
   per-element fields in one launch, Noise's draw in one);
10. config3-affine-resample: BASELINE.json config 3, ``Compose([Affine(
   scales=(0.9, 1.1), degrees=(-10, 10)), Resample(target=1.0)],
   copy=False)`` on a copy (metadata only) of B=4 subjects of a 4-channel
   192x192x96 float32 ``ch`` and an int32 ``seg`` at 1x1x2 mm, out at
   192^3 and 1 mm, the same way;
11. config4-elastic-inverse: BASELINE.json config 4 at 256^3,
   ``Compose([ElasticDeformation(max_displacement=7.5)])`` and then
   ``apply_inverse_transform()`` on B=4 subjects of a float32 ``t1`` and
   an int32 ``seg``, the same way, with the round trip's interior label
   consistency (a 12-voxel margin), which must beat the forward's alone;
   configs 3 and 4 must launch the resample kernel RESAMPLE_LAUNCHES
   times a call and the threefry kernel never;
12. config5-queue-labelsampler: BASELINE.json config 5 as
   benchmarks/patches_bench.py's bench_queue_device, at 256^3: a Queue of
   4 subjects (1 x 256^3 t1 + int32 block seg) behind ``Compose([Motion(
   degrees=5, translation=3, num_transforms=1, p=0.5), Ghosting(intensity=
   (0.3, 0.7), p=0.5)])`` in 2 worker threads, LabelSampler 64^3, 8
   patches a subject, a ring of 64, ``device_batches(batch_size=8)``, 2
   warm-up and 3 timed epochs, each batch consumed by a device-side
   ``sum().item()``; every patch centre labelled, the dense resample
   kernel launched once for each prepared subject that kept Motion and no
   other kernel; then ``SubjectsLoader(queue, batch_size=8)`` the same
   way (bench_queue); then config5-nifti-queue: the same Queue over the
   same subjects written as uncompressed ``.nii`` (float32 t1, int32 seg)
   and read by its two workers every epoch (``Subject.unload()`` between
   epochs), with the same seeds: the patch corners equal the in-memory
   run's, one dense resample launch a subject that kept Motion, the reads
   in the worker threads and overlapping, the decode in the native
   library; it prints patches/s, the reads a subject and an epoch, and
   the overlap;
13. config5b-grid-hann-aggregator: bench_aggregator(device_output=True) at
   256^3: ``GridSampler(patch_size=64, patch_overlap=16)`` (125 patches),
   ``SubjectsLoader(batch_size=4)``, an identity model, a hann
   ``PatchAggregator`` and ``get_output(device=True)``, a warm-up and 3
   timed passes, the output within the JAX package's hann tolerance of
   the input; then the same passes with ``get_output()`` to host numpy,
   and the pull alone;
14. policy-someof: ``docs/tutorials/augmentation.md:82-91``,
   ``Compose([Flip(axes=(0,), p=0.5), Spatial(scales=(0.95, 1.05),
   degrees=5.0), SomeOf([BiasField(), Blur(std=(0.1, 0.8)), Gamma()],
   num_transforms=(0, 2)), RescaleIntensity(out_min=0.0, out_max=1.0)])``
   and then ``apply_inverse_transform()`` on B=4 subjects of a 256^3
   float32 ``t1`` and an int32 block ``seg``: the SomeOf runs each
   element as a batch of one and re-stacks them with per-element
   histories, the inverse runs element by element; each call must launch
   the resample kernel 2 + 2 x 4 times (batch-wide, then each element's
   inverse) and the threefry kernel twice for each element that drew
   BiasField (its field and its inverse's), nothing else;
15. kspace-oneof: ``docs/tutorials/augmentation.md:48-52``, ``OneOf({
   Motion(): 0.5, Ghosting(): 0.3, Spike(): 0.2})`` per instance on B=4
   subjects of a 256^3 ``t1`` and an int32 ``seg``: one dense resample
   launch for each Motion move (2 an element that drew Motion), nothing
   else; ``seg`` comes back equal;
16. brats-preprocess-fused: ``Compose([Clamp(out_min=0.0),
   ZNormalization(masking_method="seg"), Mask(masking_method="seg",
   labels=[1, 2, 4])], fuse=True)`` (the members of
   ``docs/concepts/performance.md:144-150``'s fused chain) on the brats
   cell's subjects: no kernel launch, zeros outside the labels, and the
   fused run equal to the unfused one on the card, data and history;
   phases 14-16 print their median call, launches and peak beside the
   card's name and power limit, and with ``--profile`` the device time a
   call and the idle share;
17. synthseg-labels-to-image: ``Compose([Spatial(scales=(0.9, 1.1),
   degrees=10, max_displacement=7.5), LabelsToImage(label_key="seg"),
   BiasField(std=0.5), Gamma(log_gamma=(-0.3, 0.3)), Anisotropy(
   downsampling=(1.5, 5)), Noise(std=0.05), RescaleIntensity(0, 1)])`` on
   B=4 label maps of 256^3 (32 labels in blocks, made on the card): one
   resample launch a call (the labels, nearest) and a threefry launch for
   each label drawn, plus BiasField's and Noise's; the image in [0, 1];
18. ixi-preprocess-histstd: ``Compose([Reorient("RAS"), Resample(
   target=1.0), CropOrPad((224, 224, 160)), HistogramStandardization(
   landmarks, include=["t1"]), ZNormalization(include=["t1"]),
   OneHot()])`` on B=4 subjects of a 256x256x150 ``t1`` and an int32
   ``seg`` at 0.9375x0.9375x1.2 mm stored in "PLI", the landmarks from
   ``compute_histogram_landmarks`` over 8 volumes (set-up): two resample
   launches a call (the diagonal map), t1 z-normalised, the one-hot
   summing to 1, RAS at 1 mm; then ixi-nifti-preprocess: the same
   pipeline over the same volumes quantised to int16 and written as
   ``.nii.gz`` (with the int32 seg), read lazily each call, with
   ``Resample(target=<a 1 mm RAS reference .nii.gz>)`` and the landmarks
   from ``compute_histogram_landmarks`` on the 4 t1 paths: 2 resample
   launches a call, the output equal bit for bit to the same pipeline on
   the int16 volumes in memory, every file decoded by the native library;
   it prints the read and the pipeline a call and one subject's decode,
   native against plain; then ct-dicom-preprocess: 2 thoracic CT series
   in LIDC-IDRI's layout (512 x 512 x 240 int16 HU at 0.703 x 0.703 x
   1.25 mm, the image plane tilted 3 and 2 degrees), made on the host
   from a seed and written by the port's ``write_dicom_series`` (explicit
   VR little endian, 240 files of 512 KiB a series, renamed out of slice
   order), read lazily each call (``Subject(ct=ScalarImage(dir))``, the
   read in ``SubjectsBatch.from_subjects``) and sent through
   ``Compose([Reorient("RAS"), Resample(target=1.5), Clamp(-1000, 1000),
   RescaleIntensity(-1, 1), CropOrPad((224, 224, 192)), Spatial(degrees=
   10, scales=0.1, max_displacement=7.5), Noise(std=0.05)])``: the read
   equal to the volumes written bit for bit, the affine within 1e-6 mm,
   the output (2, 1, 224, 224, 192) on the card, RAS at 1.5 mm, equal bit
   for bit to the same pipeline on the int16 volumes in memory with the
   header's affine, 2 resample launches and 1 threefry launch a call and
   nothing else; it prints the read and the pipeline a call, one
   series' host read, the device time of a call (profiler) and the peak;
   then its first 4 slices in RLE, JPEG Lossless SV1 and JPEG-LS lossless,
   each as a series and as one multi-frame file, read back onto the card
   bit-equal, each JPEG frame decoded once by the native library (none
   declined) and equal to the Python decoder's, with the host times of a
   read and of a frame's decode; phases 17-18 print what phases 14-16
   print;
19. ux: the tools around a pipeline, on the card: ``warmup`` of the
   headline at B=4 x 256^3 (the host RNG state restored, one resample and
   two threefry launches, a seeded call after it bit-equal to one without
   it; its seconds and the first call's after it); ``profiling.profile``
   around 3 headline calls (Spatial timed 3 times, as the CPU test pins
   for the fused Compose, within the calls' wall time, ``forward``
   restored) and ``profiling.trace`` around one, whose trace names the
   resample and threefry kernels; the command line in subprocesses on an
   IXI t1 (.nii.gz): ``transform Affine degrees=10 --seed 0`` bit-equal to
   the same call in this process, ``info --load``, ``convert`` to .nrrd
   (reads back equal), the three at once, with each subprocess's seconds;
   the figures of a 1 x 256^3 t1 and an int32 seg on the card against the
   same subject on the CPU: the planes of the RAS view, the display
   window, the label range and the 256 frames of a sweep (axis 2) equal,
   a figure's host ms and the bytes it copies to the host, and where
   matplotlib is installed ``plot_subject``'s RGBA equal, where Pillow is
   ``make_gif``'s file equal; the subject's ``_repr_html_`` (no error row,
   64.0 MiB); and
   CornucopiaAdapter and MonaiAdapter (a stand-in monai module) equal to
   ``torch.flip`` on the card, handed tensors on the card;
19b. parallel (torch.distributed): a one-rank NCCL group (a TCP store on
   this host) and its (1, 1) mesh on the card; the headline on
   ``SubjectsBatch.shard_(mesh, spatial=True)``: Spatial through the
   halo program (one ``resample_coords`` launch, no ``resample``, no
   gather inside Spatial, no fallback warning), the output a DTensor on
   the mesh within 1e-4 of the unsharded call on the same seed; each
   shard's local program of a (1, 2) and a (1, 4) layout
   (``halo_resample_spec``'s, ``halo_blur``'s and
   ``sharded_grid_inference``'s with its fold), fed the halos its
   neighbours would send (slices of the volume on the card, zeros or the
   edge past the global ends), reassembled within 1e-4 of the (1, 1)
   program; the (1, 4) resample draws within +-3 degrees (a halo of
   about 30 rows; the headline's draws need about 70, more than a 64-row
   slab); ``make_augment_step`` at B=4 x 256^3 within 1e-4 of the
   unsharded ``augment_step`` (one ``resample_coords`` and one threefry
   launch a call); ``sharded_grid_inference`` of 1 x 256^3 (64^3
   patches overlapping by 16; hann and average; the identity and a
   Conv3d) against GridSampler + PatchAggregator on the card at rtol
   1e-6; ``process_large_volume`` of a 512 x 512 x 256 float32 ``.nii``
   (256 MiB, written in a temporary directory) with a 3-degree rotation,
   an elastic field and a J blur against the unsharded resample + blur
   within 1e-4, with its read, compute and write seconds; the threefry
   counter base: each rank's rows of a (2, 2) and a (4, 1) layout drawn
   with ``start`` bit-equal to the slice of the whole draw, words from a
   base past 2^32 equal to the plain words, and the kernel at start = 0
   timed against the kernel before the base (``probes/threefry_parent.cu``,
   built beside the package's libraries); the label and index stages
   sharded: synthseg's B=4 x 256^3 label maps through Spatial,
   RemapLabels (32 labels to 8 classes), RemoveLabels, Anisotropy,
   SequentialLabels, Contour and OneHot on ``shard_(mesh, spatial=True)``,
   and ixi's B=4 subjects through Reorient, CropOrPad, a reflect Pad,
   Crop, Resize, Swap, PCA and OneHot on ``shard_(mesh)`` with
   Reorient("RAS") and on ``shard_(mesh, spatial=True)`` with
   Reorient("PRI"): no gather and no stage in ``gathered``, each output a
   DTensor equal to the unsharded call (labels bit for bit, images within
   1e-4), with the call times and peaks; RemapLabels, RemoveLabels,
   CropOrPad along I and K and OneHot(num_classes=8) as 2 and 4 processes
   sharing the card in a gloo group at (2, 1), (1, 2) and (1, 4), each
   block bit-equal; Contour's and the reflect Pad's J planes as each
   shard's local program of (1, 2) and (1, 4);
20. one timed call of KeepLargestComponent on the brats cell's seg with a
   stray island a label (its host time and its two copies), and of
   Swap(patch_size=15, num_iterations=100) on B=4 x 256^3 (its device
   kernels a call, under the profiler);
21. each kernel against its plain version at its path's shape, timed
   kernel, plain, kernel, plain with CUDA events (the dense resample
   also against ``F.grid_sample``, its one-call library equivalent at a
   zero fill: kernel, library, kernel, library); the prefilter's three
   axis passes also timed one by one; the dense entry points
   ``ops.resample`` (B=4 x 256^3, per-element Motion grids) and
   ``ops.bspline.bspline_resample`` (cubic, B=1 of it) are called as a
   user calls them, with the launch counts zeroed around the calls, and
   the dense spline kernel also on all four elements of those grids
   (B=4 x 1 x 256^3); the
   threefry kernel at the headline's noise (B=4 x 1 x 256^3 normals),
   beside ``torch.randn`` of the same shape (Philox, another function:
   printed for scale, not as the library equivalent), with its main
   loop's SASS instructions an element (``cuobjdump -sass``) and the
   issue limit they set at the maximum SM clock (a model); the resample
   kernel also on config 3's diagonal 2 mm -> 1 mm map, beside
   ``F.interpolate(trilinear, align_corners=False)`` (the same map, which
   clamps at the border where the kernel fills: compared off the first
   and last k slice); the threefry kernel's bits mode on
   ``RingPatchBuffer.sample`` at config 5's ring and batch (two segments
   of 8 words in one launch), against the plain words.

The line before the last is ``{"kernels": [...]}``: per kernel its
launches on its path, its error against the plain version, its time, the
plain version's and the library call's (or null), and its bound: the
larger of the bytes it must move (each input read once, each output
written once) over 3.35 TB/s and the float32 operations it does over 67
TFLOP/s (an H100 SXM's peaks; the threefry kernel's integer operations
count at the float32 rate, the only CUDA-core rate the data sheet
gives), with ``roofline`` = bound / time. The last line is ``{"ok":
true, "device": {...}}``. ``--profile PATH`` also writes a
``torch.profiler`` table of two calls of each pipeline to PATH (two
epochs of config 5's Queue, two passes of its reassembly), and prints
each pipeline's device time a call.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import importlib.util
import itertools
import json
import math
import os
import random
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from importlib import metadata
from pathlib import Path

B, C, S = 4, 1, 256
BRATS_B, BRATS_C, BRATS_SHAPE = 4, 4, (240, 240, 155)
#: config 1's volume: benchmarks/suite.py's synthetic stand-in for Colin27
#: (1 mm MNI space)
CONFIG1_SHAPE = (181, 217, 181)
#: config 3's subjects (benchmarks/suite.py:169-194): a 4-channel ``ch``
#: and a label map ``seg`` of 192x192x96 voxels of 1x1x2 mm; Resample to
#: 1 mm doubles k
CONFIG3_C, CONFIG3_SHAPE, CONFIG3_SPACING = 4, (192, 192, 96), (1.0, 1.0, 2.0)
CONFIG3_OUT = (192, 192, 192)
#: config 4's interior label consistency skips this margin on every axis
#: (benchmarks/suite.py:208)
CONFIG4_MARGIN = 12
DEVICE = "cuda"
WARMUP, TIMED = 2, 5
KERNEL_ATOL = 1e-5
PREFILTER_RTOL = 1e-5
SLICE_ATOL = 1e-4
TIE_BAND = 1e-4
ORDERS = range(2, 8)
KERNELS = (
    "resample", "label_vote", "bspline_prefilter", "bspline_resample",
    "resample_coords", "bspline_coords", "threefry_normal", "threefry_bits",
)
#: threefry's normals: the kernel against the plain version (the bits
#: are held equal)
NORMAL_ATOL = 1e-6
#: threefry launches a call of each path: BiasField draws all of a
#: batch's per-element fields in one launch (a shared field too), Noise
#: one (a Rician pair too)
THREEFRY_LAUNCHES = {
    "headline": 2,
    "brats-label-bspline": 2,
    "config1-flip-noise-rescale": 1,
    "config2-blur-bias-gamma": 1,
    "config3-affine-resample": 0,
    "config4-elastic-inverse": 0,
}
#: resample-kernel launches a call: config 3's Affine and Resample each
#: resample ``ch`` (linear) and ``seg`` (nearest); config 4's
#: ElasticDeformation and its inverse each resample ``t1`` and ``seg``
RESAMPLE_LAUNCHES = {"config3-affine-resample": 4, "config4-elastic-inverse": 4}
#: operations a threefry normal takes: 2 counter adds, 20 rounds of add,
#: rotate and xor, 5 key injections of 2 adds, the final xor (73 integer
#: operations); the mantissa's shift and or; the uniform's subtract,
#: multiply, add and max; erf_inv's square, log1p, compare, two
#: subtracts, sqrt, 9 coefficient selects, 8 Horner steps of 2, the
#: |x| == 1 test and select, the product with x; the product with
#: sqrt(2) (log1p and sqrt counted as one operation each)
THREEFRY_OPS = 73 + 2 + 4 + (1 + 1 + 1 + 2 + 1 + 1 + 9 + 16 + 2 + 1 + 1) + 1
#: an H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s and
#: float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: an H100's issue width: SMs, warp schedulers an SM (one warp
#: instruction a clock each), lanes a warp, and lanes of a scheduler's
#: integer ALU pipe
SMS, SCHEDULERS, LANES, ALU_LANES = 132, 4, 32, 16
#: SASS opcodes (without modifiers) the integer ALU pipe issues, and those
#: the FMA pipe issues (IMAD included)
SASS_ALU = (
    "IADD3", "LOP3", "SHF", "ISETP", "FSETP", "FSEL", "SEL", "FMNMX", "IMNMX", "LEA", "PRMT",
    "IABS", "FLO", "POPC", "BMSK", "SGXT", "LOP", "MOV", "P2R", "R2P", "PLOP3", "VIADD",
)
SASS_FMA = ("IMAD", "FADD", "FMUL", "FFMA", "FCHK", "I2F", "F2I", "IMUL")
#: threefry::segments_kernel<true, false, unsigned int>: the normals
#: kernel of csrc/threefry.cu below 2^31 elements, no segment strided
THREEFRY_SASS_KERNEL = "_ZN8threefry15segments_kernelILb1ELb0EjEEvPvNS_5TableE"


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def headline(tio):
    return tio.Compose(
        [
            tio.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
            ),
            tio.BiasField(std=0.5),
            tio.Noise(std=0.1),
        ],
        fuse=True,
    )


def brats_pipeline(tio):
    return tio.Compose(
        [
            tio.Spatial(
                scales=(0.9, 1.1),
                degrees=(-10.0, 10.0),
                translation=(-5.0, 5.0),
                max_displacement=7.5,
                image_interpolation="bspline",
                label_interpolation="label",
            ),
            tio.BiasField(std=0.5),
            tio.Noise(std=0.1),
        ],
        fuse=True,
    )


def make_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((b, C, *shape), generator=gen, device=device)
    subjects = [tio.Subject(t1=tio.ScalarImage(data[i])) for i in range(b)]
    return tio.SubjectsBatch.from_subjects(subjects)


def suite_labels(torch, shape, device):
    """(1, *shape) int32 labels (i // 24 + j // 24 + k // 24) % 4, the
    block-structured maps of benchmarks/suite.py:61-68."""
    i, j, k = (torch.arange(n, device=device) // 24 for n in shape)
    labels = (i[:, None, None] + j[None, :, None] + k[None, None, :]) % 4
    return labels.to(torch.int32)[None]


def brats_labels(torch, shape, device):
    """(1, *shape) int32 block-structured labels in {0, 1, 2, 4}."""
    labels = suite_labels(torch, shape, device)
    labels[labels == 3] = 4
    return labels


def make_brats_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    mri = torch.rand((b, BRATS_C, *shape), generator=gen, device=device)
    seg = brats_labels(torch, shape, device)
    subjects = [
        tio.Subject(mri=tio.ScalarImage(mri[i]), seg=tio.LabelMap(seg.clone()))
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def cuda_time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of a kernel's work, the larger
    of its bytes over the memory rate and its operations over the float32
    rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_F32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output: {mangled function: [(address, opcode,
    operands, predicated)]}."""
    import re

    functions, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(3), m.group(4).strip(),
                            bool(m.group(2))))
    return functions


def loop_profile(code) -> dict:
    """A kernel's main loop (the largest region a backward branch closes)
    per element it stores (a 128-bit store is four): its instructions in
    all, and on the hot path, by pipe (``alu``, ``fma``, ``mufu``,
    ``other``) and by opcode. The hot path leaves out the code a forward
    branch skips where it stores nothing (a rare case), and the arm of an
    if/else that holds a MUFU or a CALL (erf_inv's tail, sqrt's slow path),
    where the other arm does not."""
    import collections
    import re

    def target(op, args):
        m = re.match(r"(0x[0-9a-f]+)", args)
        return int(m.group(1), 16) if op.startswith("BRA") and m else None

    first, last = 0, 0
    for addr, op, args, _ in code:
        t = target(op, args)
        if t is not None and t < addr and addr - t > last - first:
            first, last = t, addr
    loop = [ins for ins in code if first <= ins[0] <= last]
    at = {ins[0]: i for i, ins in enumerate(loop)}

    def span(lo, hi):
        return [ins[1] for ins in loop if lo <= ins[0] < hi]

    def rare(ops):
        return any(op.startswith(("MUFU", "CALL")) for op in ops)

    cold = set()
    for addr, op, args, predicated in loop:
        t = target(op, args)
        if t is None or t <= addr or not predicated or t - 16 not in at:
            continue
        _, before_op, before_args, before_pred = loop[at[t - 16]]
        join = target(before_op, before_args)
        if join is not None and join > t and not before_pred:
            then_arm, else_arm = span(addr + 16, t), span(t, join)
            if rare(then_arm) and not rare(else_arm):
                cold.add((addr + 16, t))
            elif rare(else_arm) and not rare(then_arm):
                cold.add((t, join))
        elif not any(o.startswith("STG") for o in span(addr + 16, t)):
            cold.add((addr + 16, t))
    hot = [ins for ins in loop if not any(lo <= ins[0] < hi for lo, hi in cold)]
    elements = sum(4 if ".128" in op else 2 if ".64" in op else 1
                   for _, op, _, _ in loop if op.startswith("STG"))
    if not elements:
        fail("no store in the kernel's main loop")

    def pipe(op):
        if op in SASS_ALU:
            return "alu"
        if op in SASS_FMA:
            return "fma"
        return "mufu" if op == "MUFU" else "other"

    def per_element(counter):
        return {k: v / elements for k, v in counter.most_common()}

    ops = [ins[1].split(".")[0] for ins in hot]
    return {
        "per_element": len(loop) / elements,
        "hot_per_element": len(hot) / elements,
        "pipes": per_element(collections.Counter(map(pipe, ops))),
        "ops": per_element(collections.Counter(ops)),
    }


def sass_of(config, library: Path) -> dict:
    """{mangled function: its SASS} of a built library."""
    cuobjdump = Path(config.nvcc()).with_name("cuobjdump")
    return sass_functions(subprocess.run(
        [str(cuobjdump), "-sass", str(library)], capture_output=True, text=True, check=True
    ).stdout)


def issue_limits(profile: dict, n: int, clock_mhz: float) -> tuple[float, float]:
    """(issue limit, ALU pipe limit) in ms of ``n`` elements at
    ``profile``'s hot-path instructions an element: every instruction at
    one a scheduler a clock, and the ALU's over its 16 lanes."""
    hz = clock_mhz * 1e6
    issue = profile["hot_per_element"] * n / (SMS * SCHEDULERS * LANES * hz) * 1e3
    alu = profile["pipes"].get("alu", 0.0) * n / (SMS * SCHEDULERS * ALU_LANES * hz) * 1e3
    return issue, alu


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


#: float32 operations per output voxel of a sample point: the 3x4 map
#: (9 products, 9 sums) and, with a field, 3 components x 7 lerps x 4
def point_flops(fields) -> int:
    return 18 + (84 if fields is not None else 0)


def weight_flops(order: int) -> int:
    """Operations per axis for the fold, the base and the order+1 tap
    weights (closed forms at orders 2-3, Cox-de Boor's 2^order - 1 nodes of
    5 operations per weight at 4-7)."""
    if order == 2:
        return 7 + 9
    if order == 3:
        return 7 + 28
    return 7 + (order + 1) * 5 * (2**order - 1)


def spline_flops(order: int, voxels: int, channels: int, fields) -> int:
    """Per output voxel: its point, the 3-axis fill mask (6 each), the
    weights and the T^2 products wi wj; per voxel and channel, T^2 k sums
    of T products and T - 1 sums, each times its wi wj and added:
    T^2 (2T + 1), 144 at order 3."""
    t = order + 1
    per_voxel = point_flops(fields) + 18 + 3 * weight_flops(order) + t * t
    return voxels * per_voxel + voxels * channels * t * t * (2 * t + 1)


def prefilter_flops(bs, order: int, shape) -> int:
    """The gain, every pole's start sum (3 operations a term) and its two
    sweeps (2 a sample, 3 for the anticausal start), per line and axis."""
    total = 0
    spatial = shape[-3:]
    for axis, n in enumerate(spatial):
        if n == 1:
            continue
        lines = math.prod(shape) // n
        _, constants = bs.pole_constants(order, n)
        per_line = n
        for _, horizon, _, _ in constants:
            terms = horizon if horizon < n else 2 * n - 2
            per_line += 3 * terms + 4 * (n - 1) + 3
        total += lines * per_line
    return total


def rot(ax, ay, az, scale=1.0, shift=(0.0, 0.0, 0.0), center=None):
    import numpy as np

    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    m = np.eye(4)
    m[:3, :3] = (rx @ ry @ rz) * scale
    c = np.asarray(center, np.float64)
    m[:3, 3] = c - m[:3, :3] @ c + np.asarray(shift)
    return m


def phase_device(torch, config):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    nvcc = subprocess.run(
        [config.nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "not installed"
    print(
        f"python {sys.version.split()[0]}; torch {torch.__version__};"
        f" CUDA {torch.version.cuda}; nvcc: {nvcc}; triton {triton}"
    )
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build(kl, native):
    """Every kernel library (one nvcc each, all at once) and, beside them,
    the host decode library (g++ and zlib)."""
    t0 = time.perf_counter()
    host = threading.Thread(target=native.available)
    host.start()
    start_parent_threefry(kl, kl.config)
    libraries = kl.build_all()
    host.join()
    print(
        f"build: {time.perf_counter() - t0:.2f} s, {len(libraries)} libraries in"
        f" parallel ({', '.join(lib.path().name for lib in libraries)})"
    )
    if not native.available():
        fail(f"the native decode library did not build: {native.build_error()}")
    print(f"build: native decode library {native.LIBRARY.path().name} (g++ -lz)")
    for lib in libraries:
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {lib.source.name}: {line.strip()}")


def coord_tie_mask(torch, rs, maps, fields, out_shape):
    """True where no plain-version coordinate lies within TIE_BAND of a
    .5 tie (where rounding may legitimately go either way)."""
    masks = []
    for b in range(maps.shape[0]):
        ok = torch.ones(out_shape, dtype=torch.bool, device=maps.device)
        for c in rs._element_coords(maps, fields, b, out_shape):
            ok &= (torch.abs(c - torch.floor(c) - 0.5) > TIE_BAND)
        masks.append(ok)
    return torch.stack(masks)[:, None]


def vote_ties(torch, rs, labels, maps, fields, out_shape):
    """(B, 1, *out) True where the label vote is a near tie: the top two
    label scores, or the in-bounds weight against 0.5, within TIE_BAND
    (float64 from the plain version's coordinates)."""
    ties = []
    for b in range(labels.shape[0]):
        vol = labels[b, 0]
        floors, weights = [], []
        for c, size in zip(rs._element_coords(maps, fields, b, out_shape), vol.shape):
            c = torch.zeros_like(c) if size == 1 else c.double()
            f = torch.floor(c)
            frac = c - f
            floors.append(f.long())
            weights.append(
                ((1 - frac) * ((f >= 0) & (f < size)), frac * ((f + 1 >= 0) & (f + 1 < size)))
            )
        w, labs = [], []
        for d in itertools.product((0, 1), repeat=3):
            w.append(weights[0][d[0]] * weights[1][d[1]] * weights[2][d[2]])
            ii, jj, kk = (
                torch.clamp(f + o, 0, s - 1) for f, o, s in zip(floors, d, vol.shape)
            )
            labs.append(vol[ii, jj, kk])
        w, labs = torch.stack(w, -1), torch.stack(labs, -1)
        scores = (w[..., None, :] * (labs[..., :, None] == labs[..., None, :])).sum(-1)
        top, arg = scores.max(-1)
        winner = torch.gather(labs, -1, arg[..., None])
        second = torch.where(labs != winner, scores, -1.0).max(-1).values
        wsum = w.sum(-1)
        ties.append(
            ((top - second < TIE_BAND) & (wsum > 0.5 - TIE_BAND))
            | ((wsum - 0.5).abs() < TIE_BAND)
        )
    return torch.stack(ties)[:, None]


#: (input spatial shape, output spatial shapes): non-aligned extents and
#: an output grid unlike the input; a size-1 axis; k past 128 (two of the
#: TPU kernel's 128-lane chunks)
KERNEL_SHAPES = (
    ((37, 45, 51), ((37, 45, 51), (41, 39, 47))),
    ((23, 19, 1), ((23, 19, 1),)),
    ((12, 14, 150), ((12, 14, 150),)),
)


def kernel_grids(np, rs, dev, in_shape):
    """The kernel phases' two grid specs: with and without an elastic
    field, rotated, scaled and shifted about the volume's center."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, (7, 7, 7, 3))
    center = [(s - 1) / 2 for s in in_shape]
    matrices = [
        rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
        rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
    ]
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field, None], [None, None])]


def check_launches(kl, kernel, before, calls, per_call=1):
    grown = kl.LAUNCHES[kernel] - before
    if grown != calls * per_call:
        fail(f"{calls} {kernel} calls but its launch count grew by {grown}")


#: (input spatial shape, output spatial shapes) for the row-tiled
#: resample kernels' edges: rows shorter than a thread's 4 voxels and not
#: a multiple of them; rows wider than a block's 128-voxel tile; io x b
#: past the 65,535 cap on grid z, with io past it and under it; j tiles
#: past the cap on grid y
EDGE_SHAPES = (
    ((12, 14, 20), ((9, 10, 1), (9, 10, 3), (9, 10, 5))),
    ((12, 14, 150), ((3, 4, 1100),)),
    ((12, 14, 20), ((70000, 1, 2), (40000, 1, 2), (1, 600000, 1))),
)
#: one volume of 1,291^3 voxels: offsets past 2^31, the kernels' 64-bit path
WIDE_SHAPE, WIDE_OUT = (1291, 1291, 1291), (8, 8, 8)
#: a coarse field with more k points than the kernel stages in shared
#: memory (512): upsampled whole a voxel
FINE_FIELD = (3, 3, 600, 3)


def edge_matrices(in_shape, out_shape, target=None):
    """Two maps that stretch the output grid over the input's (rotated a
    little about the output's center onto ``target``, by default the
    input's center)."""
    import numpy as np

    c_out = np.asarray([(n - 1) / 2 for n in out_shape])
    c_in = np.asarray([(n - 1) / 2 for n in in_shape] if target is None else target)
    scale = np.diag([(i - 1) / max(o - 1, 1) for i, o in zip(in_shape, out_shape)])
    matrices = []
    for angles in ((0.15, -0.1, 0.12), (-0.08, 0.17, -0.05)):
        m = rot(*angles, 1.0, (0.0, 0.0, 0.0), c_out)
        m[:3, :3] = m[:3, :3] @ scale
        m[:3, 3] = c_in - m[:3, :3] @ c_out
        matrices.append(m)
    return matrices


def edge_grids(np, rs, dev, in_shape, out_shape, b, target=None, field_shape=(7, 7, 7, 3)):
    """The (maps, fields) of :func:`edge_matrices`, with and without an
    elastic field of ``field_shape``."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, field_shape)
    matrices = edge_matrices(in_shape, out_shape, target)[:b]
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field] * b, [None] * b)]


def wide_volume(torch, dev):
    """A 1 x 1 x 1,291^3 float32 volume in [0, 1) (8.6 GB) and the point
    near its far corner that the wide cases sample around."""
    gen = torch.Generator(device=dev).manual_seed(8)
    vol = torch.rand((1, 1, *WIDE_SHAPE), generator=gen, device=dev)
    return vol, [n - 4.5 for n in WIDE_SHAPE]


def resample_cases(torch, np, rs, dev, b, c):
    """(case name, vol, [(maps, fields)], out_shape) for the grid-spec
    kernel phase: the kernel shapes, the tiling's edges and a field too
    fine to stage."""
    rng = np.random.default_rng(0)
    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            yield "", vol, kernel_grids(np, rs, dev, in_shape), out_shape
    for in_shape, out_shapes in EDGE_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            yield "edge ", vol, edge_grids(np, rs, dev, in_shape, out_shape, b), out_shape
    in_shape, out_shape = (12, 14, 20), (5, 6, 700)
    vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
    grids = edge_grids(np, rs, dev, in_shape, out_shape, b, field_shape=FINE_FIELD)
    yield f"field {FINE_FIELD} ", vol, grids[:1], out_shape


def phase_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    b, c = 2, 2
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["resample"]
    worst = {"linear": 0.0, "nearest": 0}
    cases = 0

    def check(kind, vol, grids, out_shape, fills):
        nonlocal cases
        b, c = vol.shape[:2]
        for maps, fields in grids:
            ties = coord_tie_mask(torch, rs, maps, fields, out_shape)
            for mode in ("linear", "nearest"):
                for fname, fill in fills.items():
                    fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                    args = (vol, maps, fields, fill_bc, out_shape, mode, apply_fill)
                    got = rk.resample_cuda(*args)
                    want = rs.resample_plain(*args)
                    torch.cuda.synchronize()
                    where = (
                        f"{kind}{mode} {tuple(vol.shape[2:])}->{out_shape}"
                        f" {'elastic' if fields is not None else 'affine'} fill {fname}"
                    )
                    if got.shape != (b, c, *out_shape):
                        fail(f"{where}: output shape {tuple(got.shape)}")
                    if mode == "linear":
                        err = float((got - want).abs().max())
                        worst["linear"] = max(worst["linear"], err)
                        if not err <= KERNEL_ATOL:
                            fail(f"{where}: max abs {err}")
                    else:
                        diff = int(((got != want) & ties.expand_as(got)).sum())
                        worst["nearest"] = max(worst["nearest"], diff)
                        if diff:
                            fail(f"{where}: {diff} voxels differ")
                    cases += 1

    for kind, vol, grids, out_shape in resample_cases(torch, np, rs, dev, b, c):
        check(kind, vol, grids, out_shape, fills)
    vol, corner = wide_volume(torch, dev)
    wide_fills = {**fills, "(B,C)": torch.as_tensor([[0.75]], device=dev)}
    check("wide ", vol, edge_grids(np, rs, dev, WIDE_OUT, WIDE_OUT, 1, corner), WIDE_OUT,
          wide_fills)
    del vol
    torch.cuda.empty_cache()
    check_launches(kl, "resample", before, cases)
    print(
        f"resample kernel vs plain: {cases} cases (rows of 1, 3, 5 and 1,100 voxels,"
        f" io x b and j tiles past the grid cap, a {FINE_FIELD[:3]} field, a"
        f" {'x'.join(map(str, WIDE_SHAPE))} volume); linear max abs {worst['linear']:.3g}"
        f" (limit {KERNEL_ATOL}); nearest voxels differing off ties {worst['nearest']}"
    )
    return worst["linear"]


def label_volumes(torch, np, rng, b, in_shape, dev):
    """int32 labels {0, 1, 2, 4} in blocks of 3 voxels, the same above 2^24
    (2^24 + {1, 2, 3, 5}: neighbours a float32 round trip would merge)
    and as float labels; in blocks of 8 voxels (most voxels' 8 corners
    carry one label); and drawn per voxel (the vote decides nearly every
    voxel, ties included)."""

    def blocks(size):
        coarse = rng.integers(0, 4, (b, 1, *[-(-s // size) for s in in_shape]))
        out = coarse.repeat(size, 2).repeat(size, 3).repeat(size, 4)
        out = out[:, :, : in_shape[0], : in_shape[1], : in_shape[2]].astype(np.int32)
        out[out == 3] = 4
        return torch.as_tensor(out, device=dev)

    ints = blocks(3)
    return {
        "int32": ints,
        "int32>2^24": ints + (2**24 + 1),
        "float32": ints.to(torch.float32) * 0.5,
        "uniform": blocks(8),
        "noisy": blocks(1),
    }


def tie_grids(np, rs, dev):
    """Maps that shift the input by half a voxel on each axis, and by a
    quarter on one: equal corner weights, so per-voxel labels tie often
    and exactly (the smallest label must win)."""
    shifts = ((0.5, 0.5, 0.5), (0.5, 0.25, 0.5))
    matrices = []
    for shift in shifts:
        m = np.eye(4)
        m[:3, 3] = shift
        matrices.append(m)
    return [rs._marshal_maps(matrices, [None, None], dev)]


def label_cases(torch, np, rs, dev):
    """(case name, {kind: labels}, [(maps, fields)], out_shape) for the
    label phase: the kernel shapes (also with tie-heavy maps), the row
    tiling's edges as the resample phase has them, and a field too fine
    to stage."""
    rng = np.random.default_rng(2)
    for in_shape, out_shapes in KERNEL_SHAPES:
        volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
        for out_shape in out_shapes:
            yield "", volumes, kernel_grids(np, rs, dev, in_shape), out_shape
        yield "ties ", volumes, tie_grids(np, rs, dev), in_shape
    for in_shape, out_shapes in EDGE_SHAPES:
        volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
        for out_shape in out_shapes:
            yield "edge ", volumes, edge_grids(np, rs, dev, in_shape, out_shape, 2), out_shape
    in_shape, out_shape = (12, 14, 20), (5, 6, 700)
    grids = edge_grids(np, rs, dev, in_shape, out_shape, 2, field_shape=FINE_FIELD)
    volumes = label_volumes(torch, np, rng, 2, in_shape, dev)
    yield f"field {FINE_FIELD} ", volumes, grids[:1], out_shape


def wide_labels(torch, dev):
    """A 1 x 1 x 1,291^3 int32 label volume drawn per voxel from {0, ...,
    4} (8.6 GB) and the point near its far corner that the case samples
    around."""
    gen = torch.Generator(device=dev).manual_seed(9)
    labels = torch.randint(0, 5, (1, 1, *WIDE_SHAPE), generator=gen, device=dev,
                           dtype=torch.int32)
    return labels, [n - 4.5 for n in WIDE_SHAPE]


def phase_label_kernel(torch, np, rs, rk, kl):
    dev = torch.device(DEVICE)
    before = kl.LAUNCHES["label_vote"]
    cases = voxels = 0
    differ = {"kernel shapes": 0, "the rest": 0}
    ties_total = 0

    def check(kind, name, labels, grids, out_shape):
        nonlocal cases, voxels, ties_total
        for maps, fields in grids:
            ties = vote_ties(torch, rs, labels, maps, fields, out_shape)
            for pad in (0.0, 7.0):
                got = rk.resample_label_cuda(labels, maps, fields, out_shape, pad)
                want = rs.resample_label_plain(labels, maps, fields, out_shape, pad)
                torch.cuda.synchronize()
                where = (
                    f"label {kind}{name} {tuple(labels.shape[2:])}->{out_shape}"
                    f" {'elastic' if fields is not None else 'affine'} pad {pad}"
                )
                if got.shape != want.shape or got.dtype != labels.dtype:
                    fail(f"{where}: output {tuple(got.shape)} {got.dtype}")
                diff = got != want
                old = kind == "" and name in ("int32", "int32>2^24", "float32")
                differ["kernel shapes" if old else "the rest"] += int(diff.sum())
                off = int((diff & ~ties).sum())
                if off:
                    fail(f"{where}: {off} voxels differ off near ties")
                ties_total += int(ties.sum())
                voxels += got.numel()
                cases += 1

    for kind, volumes, grids, out_shape in label_cases(torch, np, rs, dev):
        for name, labels in volumes.items():
            check(kind, name, labels, grids, out_shape)
    labels, corner = wide_labels(torch, dev)
    check("wide ", "int32", labels, edge_grids(np, rs, dev, WIDE_OUT, WIDE_OUT, 1, corner),
          WIDE_OUT)
    del labels
    torch.cuda.empty_cache()
    check_launches(kl, "label_vote", before, cases)
    total = sum(differ.values())
    print(
        f"label vote kernel vs plain: {cases} cases (int32, int32 above 2^24, float32,"
        f" blocks of 8, labels drawn per voxel, tie-heavy half-voxel shifts; rows of 1, 3,"
        f" 5 and 1,100 voxels, io x b and j tiles past the grid cap, a {FINE_FIELD[:3]}"
        f" field, a {'x'.join(map(str, WIDE_SHAPE))} volume); {total} of {voxels} voxels"
        f" differ, all at near ties ({differ['kernel shapes']} in the kernel shapes' int32,"
        f" int32 above 2^24 and float32 cases; {ties_total} near-tie voxels)"
    )
    return total


#: prefilter volumes: non-aligned (lines that do not fill the last
#: block), short axes (periodic start), a size-1 axis; 2-4 channels (the
#: output channels-last, the i pass moving them); lines of 2,100 samples
#: on each axis (smaller blocks), with 2 channels on the i axis; lines of
#: 7,300, longer than shared memory holds, on the k and i axes (device
#: memory)
PREFILTER_SHAPES = (
    (2, 2, 37, 45, 51), (1, 1, 3, 5, 40), (2, 1, 23, 19, 1), (1, 3, 20, 21, 22),
    (2, 4, 9, 40, 33), (1, 1, 2100, 3, 5), (1, 2, 2100, 3, 5), (1, 1, 3, 2100, 5),
    (1, 1, 3, 5, 2100), (1, 1, 2, 3, 7300), (1, 1, 7300, 4, 8),
)


def phase_prefilter_kernel(torch, np, bs, bk, kl):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(3)
    kernels = ("bspline_prefilter", "bspline_prefilter_global")
    before = {k: kl.LAUNCHES[k] for k in kernels}
    worst, cases, paths, moved = 0.0, 0, {}, 0
    for shape in PREFILTER_SHAPES:
        vol = torch.as_tensor(rng.random(shape, np.float32), device=dev)
        channels_last, steps = bk.prefilter_steps(shape)
        for step in steps:
            paths[step.plan.path] = paths.get(step.plan.path, 0) + len(ORDERS)
        moved += channels_last * len(ORDERS)
        layout = torch.channels_last_3d if channels_last else torch.contiguous_format
        for order in ORDERS:
            got = bk.prefilter_cuda(vol, order)
            want = bs.prefilter_plain(vol, order)
            torch.cuda.synchronize()
            err = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, err)
            if not err <= PREFILTER_RTOL or not got.is_contiguous(memory_format=layout):
                fail(f"prefilter order {order} {shape}: relative error {err}, layout {got.stride()}")
            cases += 1
    grown = {k: kl.LAUNCHES[k] - before[k] for k in kernels}
    if sum(grown.values()) != 3 * cases or grown["bspline_prefilter_global"] != paths["global"]:
        fail(f"{cases} prefilter calls, plans {paths}, launches {grown}")
    print(
        f"prefilter kernel vs plain: {cases} cases, orders 2-7; max abs error over"
        f" the largest coefficient {worst:.3g} (limit {PREFILTER_RTOL}); {moved} came out"
        f" channels-last; axis passes by path {paths}; launches {grown}"
    )
    return worst


#: spline scale-downs (input shape, output shape, scale): each output
#: step covers 2.6 or 4 input voxels, so a warp's taps spread over many
#: rows and the mirror reflections at the faces
SPLINE_SCALE_DOWNS = (((40, 90, 90), (8, 20, 20), 2.6), ((48, 100, 100), (9, 22, 22), 4.0))


def scale_down_grids(np, rs, dev, in_shape, out_shape, scale):
    """Two rotations that map the output's center onto the input's and
    scale its steps by ``scale``, with and without the kernel phases'
    elastic field."""
    field = np.random.default_rng(1).uniform(-3.0, 3.0, (7, 7, 7, 3))
    c_in = np.asarray([(n - 1) / 2 for n in in_shape])
    c_out = np.asarray([(n - 1) / 2 for n in out_shape])
    matrices = []
    for angles in ((0.15, -0.1, 0.12), (-0.08, 0.17, -0.05)):
        m = rot(*angles, scale, (0.0, 0.0, 0.0), c_out)
        m[:3, 3] = c_in - m[:3, :3] @ c_out
        matrices.append(m)
    return [rs._marshal_maps(matrices, cps, dev) for cps in ([field, None], [None, None])]


def phase_spline_kernel(torch, np, rs, bs, bk, kl):
    """Orders 2-7 with 2 channels (one a load) and 4 (four a load), on
    planar coefficients (the wrapper makes them channels-last) and on the
    prefilter kernel's channels-last ones."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(4)
    b = 2
    before = kl.LAUNCHES["bspline_resample"]
    worst, cases = 0.0, 0

    def check(kind, coeffs, maps, fields, fill, out_shape, order):
        nonlocal worst, cases
        c = coeffs.shape[1]
        fill_bc, _ = rs._fill_bc(fill, b, c, dev)
        args = (coeffs, maps, fields, fill_bc, out_shape, order)
        got = bk.bspline_resample_cuda(*args)
        want = bs.bspline_resample_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if got.shape != (b, c, *out_shape) or not err <= KERNEL_ATOL:
            fail(
                f"spline {kind} order {order} {tuple(coeffs.shape[-3:])}->{out_shape}:"
                f" shape {tuple(got.shape)}, max abs {err}"
            )
        cases += 1

    for c in (2, 4):
        fill_bc = torch.as_tensor(rng.uniform(-1.0, 2.0, (b, c)).astype(np.float32), device=dev)
        for in_shape, out_shapes in KERNEL_SHAPES:
            vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
            for order in ORDERS:
                coeffs = bs.prefilter_plain(vol, order)
                for out_shape in out_shapes:
                    for maps, fields in kernel_grids(np, rs, dev, in_shape):
                        for fill in (0.0, fill_bc):
                            check("grid", coeffs, maps, fields, fill, out_shape, order)
                check("grid, prefilter kernel's coefficients", bk.prefilter_cuda(vol, order),
                      *kernel_grids(np, rs, dev, in_shape)[0], fill_bc, out_shapes[-1], order)
        for in_shape, out_shape, scale in SPLINE_SCALE_DOWNS:
            vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
            for order in ORDERS:
                coeffs = bs.prefilter_plain(vol, order)
                for maps, fields in scale_down_grids(np, rs, dev, in_shape, out_shape, scale):
                    check("scale-down", coeffs, maps, fields, fill_bc, out_shape, order)
    check_launches(kl, "bspline_resample", before, cases)
    print(
        f"spline kernel vs plain: {cases} cases, orders 2-7, 2 and 4 channels"
        f" (scale-downs by 2.6 and 4 included); max abs {worst:.3g} (limit {KERNEL_ATOL})"
    )
    return worst


def run_on_both(tio, make, pipeline, seed):
    """``pipeline`` from one seed on the CPU and on the card: each draws
    its own noise and bias fields (the plain threefry version on the CPU,
    the kernel on the card)."""
    (cpu, gpu), _, _ = both_devices(tio, make, lambda: pipeline(tio), seed)
    if [h.params for h in cpu.applied_transforms] != [
        h.params for h in gpu.applied_transforms
    ]:
        fail("history params differ between cpu and cuda")
    return cpu, gpu


def phase_small_slice(torch, tio):
    """The headline on a small batch: card against the CPU path."""
    cpu, gpu = run_on_both(
        tio, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 3), headline, 11,
    )
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    print(f"small slice (2 x 40x44x48) cuda vs cpu: max abs {err:.3g} (limit {SLICE_ATOL})")
    if not err <= SLICE_ATOL:
        fail(f"small slice differs from the CPU path by {err}")


def slice_grids(np, rs, params, affine, shape, device):
    """The (maps, fields) of a recorded per-element Spatial draw."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    grids = [
        _build_grid(
            input_affine=affine, output_shape=shape, output_affine=affine,
            affine_matrix=params["affine_matrix"][i],
            control_points=params["control_points"][i],
            max_displacement=params["max_displacement"][i], affine_first=True,
        )
        for i in range(len(params["affine_matrix"]))
    ]
    return rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], device)


def phase_small_labelled(torch, np, tio, rs):
    """brats-label-bspline on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    cpu, gpu = run_on_both(
        tio, lambda: make_brats_batch(tio, torch, 2, shape, "cpu", 5),
        brats_pipeline, 13,
    )
    err = float((gpu.mri.data.cpu() - cpu.mri.data).abs().max())
    seg_in = brats_labels(torch, shape, "cpu").expand(2, 1, *shape)
    maps, fields = slice_grids(
        np, rs, cpu.applied_transforms[0].params, cpu.seg.affines[0], shape, "cpu"
    )
    ties = vote_ties(torch, rs, seg_in, maps, fields, shape)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"labelled slice: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small labelled slice (2 x (4 + 1) x 40x44x48) cuda vs cpu: mri max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); seg voxels differing {int((got != want).sum())},"
        f" off near ties {off}"
    )
    if not err <= SLICE_ATOL or off:
        fail("the small labelled slice differs from the CPU path")


def phase_host_subject(torch, np, tio, kl):
    """A subject and a bare array built from numpy go through the headline
    with no device named: the data lands on the card and the resample
    kernel launches; the array comes back as host numpy."""
    arr = np.random.default_rng(12).random((1, 48, 52, 56), np.float32)
    subject = tio.Subject(t1=tio.ScalarImage(arr))
    if subject.t1.data.device.type != DEVICE:
        fail(f"a numpy-built subject lies on {subject.t1.data.device}")
    before = kl.LAUNCHES["resample"]
    tio.seed(3)
    out = headline(tio)(subject)
    tio.seed(3)
    out_arr = headline(tio)(arr)
    torch.cuda.synchronize()
    launched = kl.LAUNCHES["resample"] - before
    data = out.t1.data
    if data.device.type != DEVICE or launched != 2 or not bool(torch.isfinite(data).all()):
        fail(f"numpy-built subject: output on {data.device}, {launched} resample launches")
    if not isinstance(out_arr, np.ndarray) or out_arr.shape != arr.shape:
        fail(f"numpy array through the headline came back as {type(out_arr).__name__}")
    err = float(np.abs(out_arr - data.cpu().numpy()).max())
    if err != 0.0:
        fail(f"array and subject entries differ by {err} on the same seed")
    print(
        f"numpy-built subject and array (1 x 48x52x56) through the headline on"
        f" {data.device}: resample launches {launched}; the array comes back as"
        f" numpy, equal to the subject's output"
    )


def drive(torch, kl, pipeline, batch, kernels):
    """WARMUP + TIMED calls with every launch count zeroed just before
    and read just after; returns (output, call seconds, launches per
    call per kernel, total launches per kernel, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.reset_launches()
    times, per_call, histories, out = [], [], [], None
    for _ in range(WARMUP + TIMED):
        before = dict(kl.LAUNCHES)
        t0 = time.perf_counter()
        out = pipeline(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_call.append({k: kl.LAUNCHES[k] - before[k] for k in KERNELS})
        histories.append([h.name for h in out.applied_transforms])
    totals = {k: kl.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    for k in kernels:
        if any(call[k] < 1 for call in per_call):
            fail(f"a call did not launch the {k} kernel: {[c[k] for c in per_call]}")
    return out, times, per_call, totals, peak, histories


def profile_calls(torch, pipeline, batch, path, title):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            pipeline(batch)
        torch.cuda.synchronize()
    events = p.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    # the table's "Self CUDA time total": the device events' own time
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(f"== {title}: two calls ==\n{table}\n")
    print(f"profile ({title}): device time {device_us / 2e3:.3f} ms a call; table in {path}")
    return device_us / 2e3


def phase_slice(torch, tio, kl, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 0)
    pipeline = headline(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, _ = drive(
        torch, kl, pipeline, batch, ("resample", "threefry_normal")
    )
    # BiasField draws its B coarse fields in one launch, Noise one volume
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES["headline"] for d in draws):
        fail(f"headline threefry launches per call {draws}, expected"
             f" {THREEFRY_LAUNCHES['headline']}")
    data = out.t1.data
    if tuple(data.shape) != (B, C, S, S, S) or data.device.type != DEVICE:
        fail(f"slice output {tuple(data.shape)} on {data.device}")
    if not bool(torch.isfinite(data).all()):
        fail("slice output has non-finite values")
    names = [h.name for h in out.applied_transforms]
    if names != ["Spatial", "BiasField", "Noise"]:
        fail(f"history is {names}")
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"headline slice: {vps:.2f} volumes/s over {TIMED} timed calls of B={B} x {S}^3"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first);"
        f" resample launches per call {[c['resample'] for c in per_call]}; threefry"
        f" launches per call {draws} (BiasField 1 for its {B} fields, Noise 1);"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "headline")
    return totals


def phase_brats(torch, tio, kl, profile: str | None):
    dev = torch.device(DEVICE)
    batch = make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0)
    pipeline = brats_pipeline(tio)
    tio.seed(0)
    new = ("label_vote", "bspline_prefilter", "bspline_resample", "threefry_normal")
    out, times, per_call, totals, peak, _ = drive(torch, kl, pipeline, batch, new)
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES["brats-label-bspline"] for d in draws):
        fail(f"brats threefry launches per call {draws}, expected"
             f" {THREEFRY_LAUNCHES['brats-label-bspline']}")
    mri, seg = out.mri.data, out.seg.data
    if tuple(mri.shape) != (BRATS_B, BRATS_C, *BRATS_SHAPE) or mri.device.type != DEVICE:
        fail(f"brats mri output {tuple(mri.shape)} on {mri.device}")
    if tuple(seg.shape) != (BRATS_B, 1, *BRATS_SHAPE) or seg.dtype != torch.int32:
        fail(f"brats seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(mri).all()):
        fail("brats mri output has non-finite values")
    values = set(torch.unique(seg).tolist())
    if not values <= {0, 1, 2, 4} or len(values) < 4:
        fail(f"brats seg labels {sorted(values)}, expected {{0, 1, 2, 4}}")
    names = [h.name for h in out.applied_transforms]
    if names != ["Spatial", "BiasField", "Noise"]:
        fail(f"brats history is {names}")
    timed = times[WARMUP:]
    sps = BRATS_B * TIMED / sum(timed)
    print(
        f"brats-label-bspline: {sps:.2f} subjects/s over {TIMED} timed calls of"
        f" B={BRATS_B} x ({BRATS_C} + 1) x {'x'.join(map(str, BRATS_SHAPE))}"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first);"
        f" launches per call {dict((k, per_call[-1][k]) for k in new)};"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "brats-label-bspline")
    return totals, batch


def time_pair(torch, kernel, plain, kernel_reps=20, plain_reps=3):
    """Kernel, plain, kernel, plain; returns the better of each pair."""
    ms = cuda_time_ms(torch, kernel, kernel_reps)
    plain_ms = cuda_time_ms(torch, plain, plain_reps)
    ms2 = cuda_time_ms(torch, kernel, kernel_reps)
    plain_ms2 = cuda_time_ms(torch, plain, plain_reps)
    return (ms, plain_ms, ms2, plain_ms2), min(ms, ms2), min(plain_ms, plain_ms2)


def phase_kernel_timing(torch, np, tio, rs, rk):
    """The resample kernel against the plain resample at the headline's
    shape, on the grid specs of one headline Spatial draw."""
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 1)
    tio.seed(5)
    params = headline(tio).transforms[0].make_params(batch)
    maps, fields = slice_grids(np, rs, params, batch.t1.affines[0], (S, S, S), dev)
    vol = batch.t1.data.contiguous()
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, C, dev)
    args = (vol, maps, fields, fill, (S, S, S), "linear", apply_fill)
    err = float((rk.resample_cuda(*args) - rs.resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"resample kernel vs plain at {S}^3: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), lambda: rs.resample_plain(*args)
    )
    voxels = B * S**3
    # trilinear: 8 corner weights (16 products) a voxel, 8 products and 7
    # sums a voxel and channel
    work = bound(
        nbytes(vol, maps, fields, fill) + vol.numel() * 4,
        voxels * (point_flops(fields) + 16) + voxels * C * 15,
    )
    print(
        f"resample B={B} x {S}^3 linear + elastic: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (kernel, plain, kernel, plain:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work}


def phase_brats_timing(torch, np, tio, rs, rk, bs, bk, batch):
    """The three new kernels against their plain versions at the shapes
    brats-label-bspline gives them, on the grid specs of one draw."""
    dev = torch.device(DEVICE)
    tio.seed(6)
    params = brats_pipeline(tio).transforms[0].make_params(batch)
    maps, fields = slice_grids(np, rs, params, batch.mri.affines[0], BRATS_SHAPE, dev)
    mri, seg = batch.mri.data.contiguous(), batch.seg.data.contiguous()
    results = {}

    got = rk.resample_label_cuda(seg, maps, fields, BRATS_SHAPE, 0.0)
    want = rs.resample_label_plain(seg, maps, fields, BRATS_SHAPE, 0.0)
    diff = got != want
    differ = int(diff.sum())
    label_err = float((got - want).abs().max())
    if differ:
        ties = vote_ties(torch, rs, seg, maps, fields, BRATS_SHAPE)
        if int((diff & ~ties).sum()):
            fail(f"label vote at the slice's shape: {differ} voxels differ, some off ties")
    del got, want, diff
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_label_cuda(seg, maps, fields, BRATS_SHAPE, 0.0),
        lambda: rs.resample_label_plain(seg, maps, fields, BRATS_SHAPE, 0.0),
    )
    voxels = BRATS_B * math.prod(BRATS_SHAPE)
    # the vote: 8 corner weights (16 operations), each added to its
    # label's total (7 sums: a label's first weight starts its total), the
    # top total (7 compares) and the in-bounds weight (7 sums); the label
    # compares are integer work and left out
    work = bound(
        nbytes(seg, maps, fields) + seg.numel() * 4,
        voxels * (point_flops(fields) + 16 + 7 + 7 + 7),
    )
    results["label_vote"] = {
        "max_abs_err": label_err, "ms": ms, "plain_ms": plain_ms, "bound": work,
    }
    print(
        f"label vote B={BRATS_B} x 1 x {'x'.join(map(str, BRATS_SHAPE))} int32: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); voxels differing {differ};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )

    coeffs = bk.prefilter_cuda(mri, 3)
    want = bs.prefilter_plain(mri, 3)
    abs_err = float((coeffs - want).abs().max())
    err = abs_err / float(want.abs().max())
    del want
    if not err <= PREFILTER_RTOL:
        fail(f"prefilter at the slice's shape: relative error {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.prefilter_cuda(mri, 3), lambda: bs.prefilter_plain(mri, 3)
    )
    # each axis pass alone: the first reads the volume and writes the
    # coefficients channels-last, the others work in place, as in a call
    work_buf = torch.empty_like(coeffs)
    _, steps = bk.prefilter_steps(tuple(mri.shape))
    pass_ms = []
    for n, step in enumerate(steps):
        src = mri if n == 0 else work_buf
        pass_ms.append(cuda_time_ms(
            torch, lambda st=step, x=src: bk.prefilter_pass(x, work_buf, st, 3), 20
        ))
    del work_buf
    plans = [step.plan for step in steps]
    work = bound(2 * nbytes(mri), prefilter_flops(bs, 3, tuple(mri.shape)))
    results["bspline_prefilter"] = {
        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "pass_ms": pass_ms,
    }
    print(
        f"prefilter order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {abs_err:.3g}, over the"
        f" largest coefficient {err:.3g}; passes i, j, k"
        f" {', '.join(f'{t:.3f}' for t in pass_ms)} ms"
        f" ({', '.join(f'{p.path} x {p.per_block}' for p in plans)});"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )

    fill, _ = rs._fill_bc(torch.amin(mri, dim=(-3, -2, -1)), BRATS_B, BRATS_C, dev)
    args = (coeffs, maps, fields, fill, BRATS_SHAPE, 3)
    got = bk.bspline_resample_cuda(*args)
    err = float((got - bs.bspline_resample_plain(*args)).abs().max())
    del got
    if not err <= KERNEL_ATOL:
        fail(f"spline at the slice's shape: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_resample_cuda(*args),
        lambda: bs.bspline_resample_plain(*args), plain_reps=2,
    )
    work = bound(
        nbytes(coeffs, maps, fields, fill) + coeffs.numel() * 4,
        spline_flops(3, voxels, BRATS_C, fields),
    )
    results["bspline_resample"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
    }
    print(
        f"spline order 3 B={BRATS_B} x {BRATS_C} x {'x'.join(map(str, BRATS_SHAPE))}:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return results


KSPACE_SEED = 0


def kspace_pipeline(tio):
    """BASELINE.json config 5's artifact pair (benchmarks/patches_bench.py:44-49)."""
    return tio.Compose(
        [
            tio.Motion(degrees=5, translation=3, num_transforms=1, p=0.5),
            tio.Ghosting(intensity=(0.3, 0.7), p=0.5),
        ]
    )


def block_seg(torch, shape, device):
    """(1, *shape) int32: label 1 on the central half of every axis, 0
    elsewhere, as benchmarks/patches_bench.py builds its label maps."""
    seg = torch.zeros((1, *shape), dtype=torch.int32, device=device)
    i, j, k = (n // 4 for n in shape)
    seg[0, i : shape[0] - i, j : shape[1] - j, k : shape[2] - k] = 1
    return seg


def make_kspace_batch(tio, torch, b, shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = torch.rand((b, 1, *shape), generator=gen, device=device)
    seg = block_seg(torch, shape, device)
    subjects = [
        tio.Subject(t1=tio.ScalarImage(t1[i]), seg=tio.LabelMap(seg.clone()))
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def dense_grids(torch, rs, dev, in_shape, out_shape, b, matrices=None):
    """Per-element (b, *out_shape, 3) coordinates: the kernel phases'
    rotated, scaled and shifted maps (their borders leave the volume), or
    ``matrices``, each coordinate jittered by up to one voxel."""
    if matrices is None:
        center = [(s - 1) / 2 for s in in_shape]
        matrices = [
            rot(0.15, -0.1, 0.12, 1.05, (1.5, -2.0, 0.7), center),
            rot(-0.08, 0.17, -0.05, 0.93, (-3.0, 1.0, 2.5), center),
        ]
    grids = torch.stack([rs.build_coords(out_shape, m, device=dev) for m in matrices[:b]])
    gen = torch.Generator(device=dev).manual_seed(7)
    return grids + (torch.rand(grids.shape, generator=gen, device=dev) * 2.0 - 1.0)


def phase_coords_kernel(torch, np, rs, rk, kl):
    """The dense-coordinate resample kernel against its plain version:
    linear and nearest, per-element and shared grids, every fill form,
    out-of-bounds points, a size-1 axis, the tiling's edges and a volume
    past 2^31 voxels; equal voxel for voxel."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    b, c = 2, 2
    fills = {
        "zero": 0.0,
        "scalar": 1.5,
        "(C,)": [0.5, -1.0],
        "(B,C)": torch.as_tensor([[0.25, -1.0], [2.0, 0.5]], device=dev),
    }
    before = kl.LAUNCHES["resample_coords"]
    cases = 0

    def check(kind, vol, grids, fills):
        nonlocal cases
        b, c = vol.shape[:2]
        out_shape = tuple(grids.shape[1:4])
        pairs = (("per-element", grids), ("shared", grids[:1].contiguous()))
        for grid_kind, coords in pairs[: 2 if b > 1 else 1]:
            for mode in ("linear", "nearest"):
                for fname, fill in fills.items():
                    fill_bc, apply_fill = rs._fill_bc(fill, b, c, dev)
                    args = (vol, coords, fill_bc, mode, apply_fill)
                    got = rk.resample_coords_cuda(*args)
                    want = rs.resample_coords_plain(*args)
                    torch.cuda.synchronize()
                    where = (
                        f"dense {kind}{mode} {grid_kind} {tuple(vol.shape[2:])}->{out_shape}"
                        f" fill {fname}"
                    )
                    if got.shape != (b, c, *out_shape):
                        fail(f"{where}: output shape {tuple(got.shape)}")
                    differ = int((got != want).sum())
                    if differ:
                        err = float((got - want).abs().max())
                        fail(f"{where}: {differ} voxels differ, max abs {err}")
                    cases += 1

    for in_shape, out_shapes in KERNEL_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            check("", vol, dense_grids(torch, rs, dev, in_shape, out_shape, b), fills)
    for in_shape, out_shapes in EDGE_SHAPES:
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for out_shape in out_shapes:
            matrices = edge_matrices(in_shape, out_shape)
            check("edge ", vol, dense_grids(torch, rs, dev, in_shape, out_shape, b, matrices),
                  fills)
    vol, corner = wide_volume(torch, dev)
    wide_fills = {**fills, "(C,)": [0.5], "(B,C)": torch.as_tensor([[0.75]], device=dev)}
    matrices = edge_matrices(WIDE_OUT, WIDE_OUT, corner)
    check("wide ", vol, dense_grids(torch, rs, dev, WIDE_SHAPE, WIDE_OUT, 1, matrices),
          wide_fills)
    del vol
    torch.cuda.empty_cache()
    check_launches(kl, "resample_coords", before, cases)
    print(
        f"dense resample kernel vs plain: {cases} cases (linear and nearest,"
        f" per-element and shared grids, 4 fill forms, the tiling's edges, a"
        f" {'x'.join(map(str, WIDE_SHAPE))} volume); max abs 0"
    )


def phase_coords_spline_kernel(torch, np, rs, bs, bk, kl):
    """The dense-coordinate spline kernel against its plain version,
    orders 2-7, within KERNEL_ATOL: 1, 2 and 4 channels on the kernel
    shapes and the row tiling's edges, per-element and shared grids, and
    a 1,291^3 volume taken as the coefficients (offsets past 2^31)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    b = 2
    before = kl.LAUNCHES["bspline_coords"]
    worst, cases = 0.0, 0

    def check(kind, coeffs, grids, fill_bc, order):
        nonlocal worst, cases
        b, c = coeffs.shape[:2]
        out_shape = tuple(grids.shape[1:4])
        pairs = (("per-element", grids), ("shared", grids[:1].contiguous()))
        for grid_kind, coords in pairs[: 2 if b > 1 else 1]:
            got = bk.bspline_coords_cuda(coeffs, coords, fill_bc, order)
            want = bs.bspline_coords_plain(coeffs, coords, fill_bc, order)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if got.shape != (b, c, *out_shape) or not err <= KERNEL_ATOL:
                fail(
                    f"dense spline {kind}order {order} C={c} {grid_kind}"
                    f" {tuple(coeffs.shape[2:])}->{out_shape}: shape {tuple(got.shape)},"
                    f" max abs {err}"
                )
            cases += 1

    shapes = [("", in_shape, out_shapes) for in_shape, out_shapes in KERNEL_SHAPES]
    shapes += [("edge ", in_shape, out_shapes) for in_shape, out_shapes in EDGE_SHAPES]
    for c, (kind, in_shape, out_shapes) in itertools.product((1, 2, 4), shapes):
        fill_bc = torch.as_tensor(rng.uniform(-1.0, 2.0, (b, c)).astype(np.float32), device=dev)
        vol = torch.as_tensor(rng.random((b, c, *in_shape), np.float32), device=dev)
        for order in ORDERS:
            coeffs = bs.prefilter_plain(vol, order)
            for out_shape in out_shapes:
                matrices = edge_matrices(in_shape, out_shape) if kind else None
                grids = dense_grids(torch, rs, dev, in_shape, out_shape, b, matrices)
                check(kind, coeffs, grids, fill_bc, order)
    # the wide volume's samples stand in for its coefficients: the kernel
    # and its plain version both take coefficients
    vol, corner = wide_volume(torch, dev)
    grids = dense_grids(
        torch, rs, dev, WIDE_SHAPE, WIDE_OUT, 1, edge_matrices(WIDE_OUT, WIDE_OUT, corner)
    )
    fill_bc = torch.as_tensor([[0.75]], device=dev)
    for order in ORDERS:
        check("wide ", vol, grids, fill_bc, order)
    del vol
    torch.cuda.empty_cache()
    check_launches(kl, "bspline_coords", before, cases)
    print(
        f"dense spline kernel vs plain: {cases} cases, orders 2-7, 1, 2 and 4 channels,"
        f" per-element and shared grids, the tiling's edges, a"
        f" {'x'.join(map(str, WIDE_SHAPE))} volume; max abs {worst:.3g} (limit {KERNEL_ATOL})"
    )
    return worst


def phase_small_kspace(torch, tio, kl):
    """kspace-motion-ghosting on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    before = kl.LAUNCHES["resample_coords"]
    cpu, gpu = run_on_both(
        tio, lambda: make_kspace_batch(tio, torch, B, shape, "cpu", 7), kspace_pipeline, 10,
    )
    launched = kl.LAUNCHES["resample_coords"] - before
    names = [h.name for h in gpu.applied_transforms]
    if "Motion" not in names or launched != 1:
        fail(f"small k-space batch: history {names}, {launched} dense resample launches")
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    seg_in = block_seg(torch, shape, "cpu").expand(B, 1, *shape)
    seg_ok = torch.equal(gpu.seg.data.cpu(), seg_in) and torch.equal(cpu.seg.data, seg_in)
    print(
        f"small k-space batch ({B} x 40x44x48, history {names}) cuda vs cpu: t1 max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); seg untouched {seg_ok}"
    )
    if not err <= SLICE_ATOL or not seg_ok:
        fail("the small k-space batch differs from the CPU path")


def phase_kspace(torch, tio, kl, profile: str | None):
    """kspace-motion-ghosting: config 5's Compose on B=4 x 256^3 t1 + seg."""
    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_kspace_batch(tio, torch, B, shape, dev, 0)
    seg_in = batch.seg.data.clone()
    pipeline = kspace_pipeline(tio)
    tio.seed(KSPACE_SEED)
    out, times, per_call, totals, peak, histories = drive(torch, kl, pipeline, batch, ())
    for names, call in zip(histories, per_call):
        if call["resample_coords"] != int("Motion" in names):
            fail(
                f"k-space calls: histories {histories}, dense resample launches"
                f" {[c['resample_coords'] for c in per_call]}"
            )
    kept = sum("Motion" in names for names in histories[WARMUP:])
    if 2 * kept <= TIMED:
        fail(f"only {kept} of {TIMED} timed calls kept Motion: {histories}")
    t1, seg = out.t1.data, out.seg.data
    if tuple(t1.shape) != (B, C, *shape) or t1.device.type != DEVICE or t1.dtype != torch.float32:
        fail(f"k-space t1 output {tuple(t1.shape)} {t1.dtype} on {t1.device}")
    if not bool(torch.isfinite(t1).all()):
        fail("k-space t1 output has non-finite values")
    if not torch.equal(seg, seg_in) or not torch.equal(batch.seg.data, seg_in):
        fail("k-space seg output is not the input label map")
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"kspace-motion-ghosting: {vps:.2f} volumes/s over {TIMED} timed calls of"
        f" B={B} x {S}^3 t1 (+ int32 seg)"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first); histories"
        f" {histories}; dense resample launches per call"
        f" {[c['resample_coords'] for c in per_call]}; peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, "kspace-motion-ghosting")
    return totals


def phase_dense_entry(torch, np, tio, rs, rk, bs, bk, kl):
    """The public dense-coordinate entry points at the slice's shape, as a
    user calls them, with every launch count zeroed just before and read
    just after: ``ops.resample`` on B=4 x 256^3 at the per-element grids
    of one Motion draw, and ``ops.bspline.bspline_resample`` (cubic,
    "minimum" fill) on B=1 of it. Then each kernel against its plain
    version on the same inputs, and timed; the spline kernel also on all
    B elements of the Motion grids (its plain version checked, not
    timed)."""
    from torchio_tpu_torch.transforms.intensity.motion import _rigid_voxel_matrix

    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_kspace_batch(tio, torch, B, shape, dev, 1)
    tio.seed(5)
    params = tio.Motion(degrees=5, translation=3, num_transforms=1).make_params(batch)
    coords = torch.stack(
        [
            tio.ops.build_coords(
                shape, _rigid_voxel_matrix(t[0]["degrees"], t[0]["translation"], shape),
                device=dev,
            )
            for t in params["transforms"]
        ]
    )
    vol = batch.t1.data.contiguous()
    vol1, coords1 = vol[:1], coords[:1]
    fill1 = torch.amin(vol1, dim=(-3, -2, -1))
    torch.cuda.synchronize()
    kl.reset_launches()
    got_a = tio.ops.resample(vol, coords, mode="linear", fill=0.0)
    got_b = bs.bspline_resample(vol1, coords1, order=3, fill=fill1)
    torch.cuda.synchronize()
    launches = {k: kl.LAUNCHES[k] for k in KERNELS}
    want = {"resample_coords": 1, "bspline_coords": 1, "bspline_prefilter": 3}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"dense entry points: launches {launches}, expected {want}")

    fill_a, apply_a = rs._fill_bc(0.0, B, C, dev)
    args_a = (vol, coords, fill_a, "linear", apply_a)
    err_a = float((got_a - rs.resample_coords_plain(*args_a)).abs().max())
    got_kernel_a = got_a
    coeffs = bk.prefilter_cuda(vol1, 3)
    fill_b, _ = rs._fill_bc(fill1, 1, C, dev)
    args_b = (coeffs, coords1, fill_b, 3)
    err_b = float((got_b - bs.bspline_coords_plain(*args_b)).abs().max())
    del got_a, got_b
    if not err_a <= KERNEL_ATOL or not err_b <= KERNEL_ATOL:
        fail(f"dense entry points vs plain: max abs {err_a} (resample), {err_b} (spline)")
    results = {}
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_coords_cuda(*args_a),
        lambda: rs.resample_coords_plain(*args_a),
    )
    # the one PyTorch call of the same function at a zero fill: grid_sample
    # takes (x, y, z) = (k, j, i) normalised to [-1, 1] (align_corners);
    # the conversion is outside the timed window
    scale = torch.tensor([2.0 / (n - 1) for n in reversed(shape)], device=dev)
    grid = (coords.flip(-1) * scale - 1.0).contiguous()
    library = torch.nn.functional.grid_sample
    lib_args = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    lib_err = float((library(vol, grid, **lib_args) - got_kernel_a).abs().max())
    del got_kernel_a
    lib_order, _, library_ms = time_pair(
        torch, lambda: rk.resample_coords_cuda(*args_a),
        lambda: library(vol, grid, **lib_args), plain_reps=20,
    )
    del grid
    voxels = B * S**3
    work = bound(
        nbytes(vol, coords, fill_a) + vol.numel() * 4,
        voxels * 16 + voxels * C * 15,
    )
    results["resample_coords"] = {
        "max_abs_err": err_a, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "library_ms": library_ms,
    }
    print(
        f"dense resample B={B} x {S}^3 linear, per-element Motion grids: kernel"
        f" {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err_a:.3g};"
        f" F.grid_sample {library_ms:.3f} ms (k, l, k, l:"
        f" {', '.join(f'{t:.3f}' for t in lib_order)}), max abs vs the kernel"
        f" {lib_err:.3g}; bound {work[0]:.3f} ms ({work[1]})"
    )
    order, ms, plain_ms = time_pair(
        torch, lambda: bk.bspline_coords_cuda(*args_b),
        lambda: bs.bspline_coords_plain(*args_b), plain_reps=2,
    )
    voxels = S**3
    # a read point needs no map: the mask and the weights
    work = bound(
        nbytes(coeffs, coords1, fill_b) + coeffs.numel() * 4,
        spline_flops(3, voxels, C, None) - voxels * point_flops(None),
    )
    print(
        f"dense spline order 3 B=1 x {S}^3, a Motion grid: kernel {ms:.3f} ms, plain"
        f" {plain_ms:.3f} ms (k, p, k, p: {', '.join(f'{t:.3f}' for t in order)});"
        f" max abs {err_b:.3g}; dense-entry launches {launches};"
        f" bound {work[0]:.3f} ms ({work[1]}), roofline {work[0] / ms:.3f}"
    )
    del coeffs, args_b
    # B=4 on the per-element Motion grids the dense resample is timed on
    # (the plain version is held to it once, not timed)
    coeffs = bk.prefilter_cuda(vol, 3)
    fill_4, _ = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, C, dev)
    args_4 = (coeffs, coords, fill_4, 3)
    err_4 = float((bk.bspline_coords_cuda(*args_4) - bs.bspline_coords_plain(*args_4)).abs().max())
    if not err_4 <= KERNEL_ATOL:
        fail(f"dense spline B={B} vs plain: max abs {err_4}")
    ms_4 = min(cuda_time_ms(torch, lambda: bk.bspline_coords_cuda(*args_4), 20) for _ in range(2))
    work_4 = bound(
        nbytes(coeffs, coords, fill_4) + coeffs.numel() * 4,
        spline_flops(3, B * voxels, C, None) - B * voxels * point_flops(None),
    )
    results["bspline_coords"] = {
        "max_abs_err": max(err_b, err_4), "ms": ms, "plain_ms": plain_ms, "bound": work,
        "b4": {
            "ms": ms_4, "max_abs_err": err_4, "bound_ms": work_4[0], "bound_by": work_4[1],
            "roofline": work_4[0] / ms_4,
        },
    }
    print(
        f"dense spline order 3 B={B} x {S}^3, per-element Motion grids: kernel {ms_4:.3f} ms"
        f" (the better of two runs of 20); max abs {err_4:.3g};"
        f" bound {work_4[0]:.3f} ms ({work_4[1]}), roofline {work_4[0] / ms_4:.3f}"
    )
    return results, launches


def config1_pipeline(tio):
    """BASELINE.json config 1 (benchmarks/suite.py:96-111)."""
    return tio.Compose(
        [
            tio.Flip(axes=(0,), flip_probability=0.5),
            tio.Noise(std=0.1),
            tio.RescaleIntensity(out_min=0.0, out_max=1.0),
        ],
        fuse=True,
    )


def config2_pipeline(tio):
    """BASELINE.json config 2 (benchmarks/suite.py:145-166), unfused."""
    return tio.Compose(
        [
            tio.Blur(std=(0.5, 1.5)),
            tio.BiasField(std=0.5),
            tio.Gamma(log_gamma=(-0.3, 0.3)),
        ]
    )


#: (name, shape) of the threefry kernel's checks: draws shorter than a
#: block, not a multiple of its 256 threads, past one grid-stride turn,
#: and the headline's noise
THREEFRY_SHAPES = (
    ("one", (1,)),
    ("255", (255,)),
    ("257", (257,)),
    ("odd", (3, 5, 7, 11)),
    ("strided", (1_000_003,)),
    ("headline", (B, C, S, S, S)),
)
#: a draw past 2^32 words (17 GB of each type): the 64-bit instantiation
#: and the counter's high word; its head, the words around 2^31 and 2^32,
#: and its tail are held against the plain version
THREEFRY_WIDE = 2**32 + 2**20


def threefry_keys(tr):
    """Keys as the port derives them: PRNGKey of a seed, keys from split,
    and words with the top bit set."""
    return {
        "PRNGKey(42)": tr.prng_key(42),
        "split(PRNGKey(7), 3)[1]": tr.split(tr.prng_key(7), 3)[1],
        "Noise image 0, k2": tr.draw_key(2**31 - 2, 2),
        "(0xFFFFFFFF, 0x80000001)": (0xFFFFFFFF, 0x80000001),
    }


def phase_threefry_kernel(torch, tr, tk, kl):
    """The threefry kernel against its plain version: words equal, normals
    within NORMAL_ATOL."""
    dev = torch.device(DEVICE)
    before = {k: kl.LAUNCHES[k] for k in ("threefry_bits", "threefry_normal")}
    worst, exact, total, cases = 0.0, 0, 0, 0
    for key_name, key in threefry_keys(tr).items():
        for name, shape in THREEFRY_SHAPES:
            if name == "headline" and key_name != "PRNGKey(42)":
                continue
            n = math.prod(shape)
            words = tr.bits_plain(key, 0, n, dev)
            got = tk.threefry_bits_cuda(key, shape, dev).view(torch.int32).reshape(-1)
            want = tr.as_uint32(words).view(torch.int32)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            if tuple(tk.threefry_bits_cuda(key, shape, dev).shape) != shape or differ:
                fail(f"threefry bits {key_name} {shape}: {differ} words differ")
            normal = tk.threefry_normal_cuda(key, shape, dev).reshape(-1)
            plain = tr.normal_of_bits(words)
            torch.cuda.synchronize()
            diff = (normal - plain).abs()
            err = float(diff.max())
            worst = max(worst, err)
            exact += int((diff == 0).sum())
            total += n
            if not err <= NORMAL_ATOL:
                fail(f"threefry normals {key_name} {shape}: max abs {err}")
            cases += 1
            del words, got, want, normal, plain, diff
    torch.cuda.empty_cache()
    grown = {k: kl.LAUNCHES[k] - before[k] for k in before}
    if grown != {"threefry_bits": 2 * cases, "threefry_normal": cases}:
        fail(f"{cases} threefry cases, launches {grown}")
    # past 2^32 words: the 64-bit path carries the counter's high word
    key = tr.prng_key(42)
    spans = ((0, 2**20), (2**31 - 2**19, 2**20), (2**32 - 2**19, 2**20),
             (THREEFRY_WIDE - 2**19, 2**19))
    wide_err = 0.0
    for kind in ("bits", "normal"):
        if kind == "bits":
            out = tk.threefry_bits_cuda(key, (THREEFRY_WIDE,), dev).view(torch.int32)
        else:
            out = tk.threefry_normal_cuda(key, (THREEFRY_WIDE,), dev)
        for start, count in spans:
            words = tr.bits_plain(key, start, count, dev)
            piece = out[start : start + count]
            if kind == "bits":
                if not torch.equal(piece, tr.as_uint32(words).view(torch.int32)):
                    fail(f"threefry bits past 2^31: words [{start}, {start + count}) differ")
            else:
                err = float((piece - tr.normal_of_bits(words)).abs().max())
                wide_err = max(wide_err, err)
                if not err <= NORMAL_ATOL:
                    fail(f"threefry normals past 2^31: [{start}, +{count}) max abs {err}")
        del out
        torch.cuda.empty_cache()
    print(
        f"threefry kernel vs plain: {cases} draws (shapes"
        f" {', '.join(name for name, _ in THREEFRY_SHAPES)}; {len(threefry_keys(tr))} keys),"
        f" words equal; normals max abs {worst:.3g} (limit {NORMAL_ATOL}),"
        f" {exact / total:.4%} equal; a draw of {THREEFRY_WIDE:,} words and normals (past 2^32):"
        f" words equal, normals max abs {wide_err:.3g}; launches {grown}"
    )
    return max(worst, wide_err, phase_threefry_segments(torch, tr, tk, kl))


def threefry_segment_cases(tr, tk):
    """(name, keys, counts, scales) of the segmented kernel's checks."""
    keys = threefry_keys(tr)
    fields = [tr.draw_key(seed, 0) for seed in (3, 99, 2**31 - 2, 12345)]
    stds = [0.5, 0.0, -1.25, 0.3]
    many = tr.split(tr.prng_key(7), tk.MAX_SEGMENTS + 1)
    n = B * C * S**3
    return (
        ("one segment", [keys["PRNGKey(42)"]], [1_000_003], None),
        (f"BiasField {B} x 216", fields, [216] * B, stds),
        (f"BiasField {B} x 576", fields, [576] * B, stds),
        ("1, 3, 5 (unaligned)", list(keys.values())[:3], [1, 3, 5], [2.0, -1.0, 0.0]),
        (
            f"cap + 1 = {tk.MAX_SEGMENTS + 1}", many,
            [(i * 37) % 101 + 1 for i in range(len(many))],
            [float(i - 24) / 8 for i in range(len(many))],
        ),
        (f"Rician pair {B} x {C} x {S}^3", [tr.draw_key(77, 1), tr.draw_key(77, 2)], [n, n], None),
    )


def phase_threefry_segments(torch, tr, tk, kl):
    """The segmented kernel against separate draws: its words equal to the
    plain version's; its normals equal to the kernel's separate draws times
    their scales (a torch multiply), and within NORMAL_ATOL of the plain
    version; one launch a MAX_SEGMENTS segments."""
    dev = torch.device(DEVICE)
    worst, lines = 0.0, []
    for name, keys, counts, scales in threefry_segment_cases(tr, tk):
        before = {k: kl.LAUNCHES[k] for k in ("threefry_bits", "threefry_normal")}
        words = tk.threefry_segments_cuda(keys, counts, None, dev, normal=False)
        got = tk.threefry_segments_cuda(keys, counts, scales, dev)
        grown = {k: kl.LAUNCHES[k] - before[k] for k in before}
        expect = -(-len(keys) // tk.MAX_SEGMENTS)
        if grown != {"threefry_bits": expect, "threefry_normal": expect}:
            fail(f"threefry segments {name}: launches {grown}, expected {expect} of each")
        offset, err, separate_equal = 0, 0.0, True
        for i, (key, count) in enumerate(zip(keys, counts)):
            piece = slice(offset, offset + count)
            plain_words = tr.bits_plain(key, 0, count, dev)
            if not torch.equal(words[piece], tr.as_uint32(plain_words).view(torch.int32)):
                fail(f"threefry segments {name}: segment {i}'s words differ")
            separate = tk.threefry_normal_cuda(key, (count,), dev)
            plain = tr.normal_of_bits(plain_words)
            if scales is not None:
                scale = torch.tensor(scales[i], dtype=torch.float32, device=dev)
                separate, plain = separate * scale, plain * scale
            separate_equal &= torch.equal(got[piece], separate)
            err = max(err, float((got[piece] - plain).abs().max()))
            offset += count
            del plain_words, separate, plain
        if not separate_equal:
            fail(f"threefry segments {name}: normals differ from the separate draws")
        if not err <= NORMAL_ATOL:
            fail(f"threefry segments {name}: normals max abs {err} from the plain version")
        worst = max(worst, err)
        lines.append(f"{name} ({len(keys)} segment{'s' * (len(keys) > 1)}, {expect}"
                     f" launch{'es' * (expect > 1)}):"
                     f" max abs {err:.3g}")
        del words, got
        torch.cuda.empty_cache()
    print(
        "threefry segments vs separate draws: words equal to the plain version's, normals"
        f" equal to the kernel's separate draws times their scales; {'; '.join(lines)}"
    )
    return worst


def phase_threefry_timing(torch, config, tr, tk):
    """The threefry kernel at the headline's noise (B x C x S^3 normals):
    kernel against plain, then kernel against torch.randn (Philox: another
    function, printed for scale only)."""
    dev = torch.device(DEVICE)
    key = tr.draw_key(2024, 1)
    shape = (B, C, S, S, S)
    n = math.prod(shape)
    got = tk.threefry_normal_cuda(key, shape, dev)
    want = tr.normal_of_bits(tr.bits_plain(key, 0, n, dev)).reshape(shape)
    diff = (got - want).abs()
    err, share = float(diff.max()), float((diff == 0).float().mean())
    del got, want, diff
    if not err <= NORMAL_ATOL:
        fail(f"threefry normals at the headline's shape: max abs {err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: tk.threefry_normal_cuda(key, shape, dev),
        lambda: tr.normal_of_bits(tr.bits_plain(key, 0, n, dev)),
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    randn_order, _, randn_ms = time_pair(
        torch, lambda: tk.threefry_normal_cuda(key, shape, dev),
        lambda: torch.randn(shape, generator=gen, device=dev), plain_reps=20,
    )
    # reads nothing, writes 4 bytes an element
    work = bound(4 * n, n * THREEFRY_OPS)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    functions = sass_of(config, tk.THREEFRY.path())
    if THREEFRY_SASS_KERNEL not in functions:
        fail(f"no {THREEFRY_SASS_KERNEL} in the threefry library's SASS")
    sass = loop_profile(functions[THREEFRY_SASS_KERNEL])
    issue_ms, alu_ms = issue_limits(sass, n, clock_mhz)
    print(
        f"threefry normals B={B} x {S}^3: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k,"
        f" p: {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}, {share:.4%} equal;"
        f" torch.randn (Philox, not the same function) {randn_ms:.3f} ms (k, r, k, r:"
        f" {', '.join(f'{t:.3f}' for t in randn_order)}); bound {work[0]:.3f} ms ({work[1]},"
        f" {THREEFRY_OPS} operations an element); SASS of the loop {sass['per_element']:g}"
        f" instructions an element, {sass['hot_per_element']:g} on its hot path"
        f" ({', '.join(f'{k} {v:g}' for k, v in sass['pipes'].items())}):"
        f" issue limit {issue_ms:.3f} ms, ALU pipe limit {alu_ms:.3f} ms at the maximum SM"
        f" clock, {clock_mhz:g} MHz (a model, not measured); opcodes {sass['ops']}"
    )
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "randn_ms": randn_ms,
    }


def phase_small_config(torch, tio, number):
    """Config 1 or 2 on a small batch: card against the CPU path."""
    pipeline = config1_pipeline if number == 1 else config2_pipeline
    cpu, gpu = run_on_both(
        tio, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 20 + number),
        pipeline, 30 + number,
    )
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    names = [h.name for h in gpu.applied_transforms]
    print(
        f"small config {number} (2 x 40x44x48, history {names}) cuda vs cpu: max abs"
        f" {err:.3g} (limit {SLICE_ATOL})"
    )
    if not err <= SLICE_ATOL:
        fail(f"small config {number} differs from the CPU path by {err}")


def phase_config(torch, tio, kl, number, profile: str | None):
    """config1-flip-noise-rescale (B=4 x 1 x 181x217x181, fused) or
    config2-blur-bias-gamma (B=4 x 1 x 256^3, unfused)."""
    dev = torch.device(DEVICE)
    if number == 1:
        name, shape, pipeline = "config1-flip-noise-rescale", CONFIG1_SHAPE, config1_pipeline(tio)
        want_names = [["Flip", "Noise", "Normalize"], ["Noise", "Normalize"]]
    else:
        name, shape, pipeline = "config2-blur-bias-gamma", (S, S, S), config2_pipeline(tio)
        want_names = [["Blur", "BiasField", "Gamma"]]
    batch = make_batch(tio, torch, B, shape, dev, number)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(
        torch, kl, pipeline, batch, ("threefry_normal",)
    )
    draws = [c["threefry_normal"] for c in per_call]
    if any(d != THREEFRY_LAUNCHES[name] for d in draws):
        fail(f"{name} threefry launches per call {draws}, expected {THREEFRY_LAUNCHES[name]}")
    data = out.t1.data
    if tuple(data.shape) != (B, C, *shape) or data.device.type != DEVICE:
        fail(f"{name} output {tuple(data.shape)} on {data.device}")
    if not bool(torch.isfinite(data).all()):
        fail(f"{name} output has non-finite values")
    if any(h not in want_names for h in histories):
        fail(f"{name} histories {histories}")
    if number == 1:
        low, high = float(data.min()), float(data.max())
        if low < 0.0 or high > 1.0:
            fail(f"{name} output spans [{low}, {high}], not [0, 1]")
        in_range = out.applied_transforms[-1].params["in_ranges"]["t1"]
        extra = f"; output in [{low:.3g}, {high:.3g}], the input range {in_range}"
    else:
        extra = ""
    timed = times[WARMUP:]
    vps = B * TIMED / sum(timed)
    print(
        f"{name}: {vps:.2f} volumes/s over {TIMED} timed calls of B={B} x"
        f" {'x'.join(map(str, shape))} (median call {statistics.median(timed) * 1e3:.1f} ms,"
        f" calls {[round(t * 1e3, 1) for t in times]} ms, warm-up first); threefry launches"
        f" per call {[c['threefry_normal'] for c in per_call]}; histories"
        f" {[len(h) for h in histories]} transforms; peak allocated {peak / 2**30:.2f} GiB{extra}"
    )
    if profile:
        profile_calls(torch, pipeline, batch, profile, name)
    return totals


def config3_pipeline(tio):
    """BASELINE.json config 3 (benchmarks/suite.py:169-194)."""
    return tio.Compose(
        [tio.Affine(scales=(0.9, 1.1), degrees=(-10.0, 10.0)), tio.Resample(target=1.0)],
        copy=False,
    )


def config3_call(tio):
    """One config 3 call as the suite makes it: the pipeline works in
    place (copy=False) and Resample changes the shape, so each call starts
    from a copy of the batch (metadata only: the copy shares the
    tensors)."""
    pipeline = config3_pipeline(tio)
    return lambda batch: pipeline(copy.deepcopy(batch))


def config4_forward(tio):
    """BASELINE.json config 4's forward (benchmarks/suite.py:197-229)."""
    return tio.Compose([tio.ElasticDeformation(max_displacement=7.5)])


def config4_call(tio):
    """One config 4 call: the elastic forward, then its inverse built from
    the recorded history (a Compose of the inverse)."""
    forward = config4_forward(tio)
    return lambda batch: forward(batch).apply_inverse_transform()


def make_suite_batch(tio, torch, b, images, shape, spacing, device, seed):
    """B subjects as benchmarks/suite.py:51-74 builds them: a ScalarImage
    of uniform [0, 1) values for each name -> channels of ``images`` and
    an int32 ``seg`` (suite_labels), all at ``spacing`` mm."""
    affine = [[spacing[0], 0, 0, 0], [0, spacing[1], 0, 0], [0, 0, spacing[2], 0], [0, 0, 0, 1]]
    gen = torch.Generator(device=device).manual_seed(seed)
    data = {
        name: torch.rand((b, c, *shape), generator=gen, device=device)
        for name, c in images.items()
    }
    seg = suite_labels(torch, shape, device)
    subjects = [
        tio.Subject(
            **{name: tio.ScalarImage(d[i], affine=affine) for name, d in data.items()},
            seg=tio.LabelMap(seg.clone(), affine=affine),
        )
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def target_grids(rs, params, affine, b, device):
    """(maps, fields, output shape) of a recorded Resample draw (no
    geometry, a target space) from input ``affine``."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid, _deserialize_space

    shape, target_affine = _deserialize_space(params["target"])
    matrix, _ = _build_grid(
        input_affine=affine, output_shape=shape, output_affine=target_affine,
        affine_matrix=None, control_points=None, max_displacement=None, affine_first=True,
    )
    return (*rs._marshal_maps([matrix] * b, [None] * b, device), shape)


def inverse_grids(np, rs, tio, params, affine, shape, device):
    """(maps, fields) of the inverse of a recorded per-element Spatial
    draw, as its inverse builds them."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    geometry = object.__new__(tio.Spatial).inverse(params).per_sample
    grids = [
        _build_grid(
            input_affine=affine, output_shape=shape, output_affine=affine,
            affine_matrix=geometry.affines[i], control_points=geometry.control_points[i],
            max_displacement=geometry.max_displacements[i],
            affine_first=not params["affine_first"],
        )
        for i in range(len(geometry))
    ]
    return rs._marshal_maps([g[0] for g in grids], [g[1] for g in grids], device)


def nearest_ties(torch, rs, maps, fields, out_shape, earlier=None):
    """(B, 1, *out) True where a nearest-neighbour label of this step may
    legitimately differ between two devices: its own coordinate lies
    within TIE_BAND of a .5 tie, or it reads a voxel that was a tie of the
    step before (``earlier``)."""
    ties = ~coord_tie_mask(torch, rs, maps, fields, out_shape)
    if earlier is not None:
        fill, _ = rs._fill_bc(0.0, maps.shape[0], 1, maps.device)
        read = rs.resample_plain(
            earlier.float(), maps, fields, fill, out_shape, "nearest", False
        )
        ties |= read > 0
    return ties


def check_path_launches(name, per_call):
    """The resample kernel RESAMPLE_LAUNCHES[name] times a call of the
    path, the threefry kernel THREEFRY_LAUNCHES[name] times."""
    resample = [c["resample"] for c in per_call]
    draws = [c["threefry_normal"] for c in per_call]
    if any(n != RESAMPLE_LAUNCHES[name] for n in resample) or any(
        n != THREEFRY_LAUNCHES[name] for n in draws
    ):
        fail(
            f"{name}: resample launches per call {resample} (expected"
            f" {RESAMPLE_LAUNCHES[name]}), threefry {draws} (expected"
            f" {THREEFRY_LAUNCHES[name]})"
        )
    return resample, draws


def phase_small_config3(torch, np, tio, rs, kl):
    """Config 3 on a small batch: card against the CPU path; labels
    equal off near ties of the Affine step (Resample's k coordinates land
    on .25 and .75)."""
    shape = (40, 44, 24)
    before = kl.LAUNCHES["resample"]
    cpu, gpu = run_on_both(
        tio,
        lambda: make_suite_batch(
            tio, torch, 2, {"ch": CONFIG3_C}, shape, CONFIG3_SPACING, "cpu", 23
        ),
        config3_call, 33,
    )
    launched = kl.LAUNCHES["resample"] - before
    out_shape = (40, 44, 48)
    if tuple(gpu.ch.data.shape) != (2, CONFIG3_C, *out_shape) or launched != 4:
        fail(f"small config 3: ch {tuple(gpu.ch.data.shape)}, {launched} resample launches")
    err = float((gpu.ch.data.cpu() - cpu.ch.data).abs().max())
    affine = tio.AffineMatrix(np.diag([*CONFIG3_SPACING, 1.0]))
    history = [h.params for h in cpu.applied_transforms]
    maps, fields = slice_grids(np, rs, history[0], affine, shape, "cpu")
    ties = nearest_ties(torch, rs, maps, fields, shape)
    maps, fields, _ = target_grids(rs, history[1], affine, 2, "cpu")
    ties = nearest_ties(torch, rs, maps, fields, out_shape, earlier=ties)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"small config 3: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small config 3 (2 x ({CONFIG3_C} + 1) x 40x44x24 at 1x1x2 mm -> 40x44x48)"
        f" cuda vs cpu: ch max abs {err:.3g} (limit {SLICE_ATOL}); seg voxels differing"
        f" {int((got != want).sum())}, off near ties {off}; resample launches {launched}"
    )
    if not err <= SLICE_ATOL or off:
        fail("small config 3 differs from the CPU path")


def phase_small_config4(torch, np, tio, rs, kl):
    """Config 4 on a small batch: forward and inverse, card against the
    CPU path; labels equal off near ties of either step."""
    shape = (40, 44, 48)
    before = kl.LAUNCHES["resample"]
    torch.exp(torch.zeros(1 << 20))  # warm the CPU thread pool (run_on_both)
    outs = []
    with warnings.catch_warnings():
        # a 7.5 mm displacement on a 40 mm volume may fold
        warnings.filterwarnings("ignore", "The maximum displacement")
        for device in ("cpu", DEVICE):
            batch = make_suite_batch(tio, torch, 2, {"t1": 1}, shape, (1, 1, 1), "cpu", 24)
            tio.seed(34)
            forward = config4_forward(tio)(batch.to(device))
            outs.append((forward, forward.apply_inverse_transform()))
        launched = kl.LAUNCHES["resample"] - before
        (cpu_fwd, cpu), (gpu_fwd, gpu) = outs
        params = cpu_fwd.applied_transforms[0].params
        if params != gpu_fwd.applied_transforms[0].params or launched != 4:
            fail(f"small config 4: params differ or {launched} resample launches")
        if gpu.applied_transforms or tuple(gpu.t1.data.shape) != (2, 1, *shape):
            fail(f"small config 4: history {gpu.applied_transforms}, t1 {tuple(gpu.t1.data.shape)}")
        err = max(
            float((g.t1.data.cpu() - c.t1.data).abs().max())
            for g, c in ((gpu_fwd, cpu_fwd), (gpu, cpu))
        )
        affine = tio.AffineMatrix(np.eye(4))
        maps, fields = slice_grids(np, rs, params, affine, shape, "cpu")
        ties = nearest_ties(torch, rs, maps, fields, shape)
        maps, fields = inverse_grids(np, rs, tio, params, affine, shape, "cpu")
        ties = nearest_ties(torch, rs, maps, fields, shape, earlier=ties)
    got, want = gpu.seg.data.cpu(), cpu.seg.data
    if got.dtype != torch.int32 or want.dtype != torch.int32:
        fail(f"small config 4: seg dtypes {got.dtype} / {want.dtype}")
    off = int(((got != want) & ~ties).sum())
    print(
        f"small config 4 (2 x (1 + 1) x 40x44x48, elastic and its inverse) cuda vs cpu:"
        f" t1 max abs {err:.3g} (limit {SLICE_ATOL}); seg voxels differing"
        f" {int((got != want).sum())}, off near ties {off}; resample launches {launched}"
    )
    if not err <= SLICE_ATOL or off:
        fail("small config 4 differs from the CPU path")


def phase_config3(torch, tio, kl, profile: str | None):
    """config3-affine-resample: B=4 subjects of a 4-channel 192x192x96
    ``ch`` and a ``seg`` at 1x1x2 mm, resampled to 1 mm (192^3)."""
    name = "config3-affine-resample"
    dev = torch.device(DEVICE)
    batch = make_suite_batch(
        tio, torch, B, {"ch": CONFIG3_C}, CONFIG3_SHAPE, CONFIG3_SPACING, dev, 3
    )
    call = config3_call(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(torch, kl, call, batch, ("resample",))
    resample, draws = check_path_launches(name, per_call)
    ch, seg = out.ch.data, out.seg.data
    if tuple(ch.shape) != (B, CONFIG3_C, *CONFIG3_OUT) or ch.device.type != DEVICE:
        fail(f"{name} ch output {tuple(ch.shape)} on {ch.device}")
    if tuple(seg.shape) != (B, 1, *CONFIG3_OUT) or seg.dtype != torch.int32:
        fail(f"{name} seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(ch).all()):
        fail(f"{name} ch output has non-finite values")
    values = set(torch.unique(seg).tolist())
    if not values <= {0, 1, 2, 3} or len(values) < 4:
        fail(f"{name} seg labels {sorted(values)}, expected {{0, 1, 2, 3}}")
    spacing = out.ch.affines[0].spacing
    if any(h != ["Affine", "Resample"] for h in histories) or spacing != (1.0, 1.0, 1.0):
        fail(f"{name} histories {histories}, output spacing {spacing}")
    if tuple(batch.ch.data.shape) != (B, CONFIG3_C, *CONFIG3_SHAPE):
        fail(f"{name} changed its input batch")
    timed = times[WARMUP:]
    print(
        f"{name}: {B * TIMED / sum(timed):.2f} subjects/s over {TIMED} timed calls of"
        f" B={B} x ({CONFIG3_C} + 1) x {'x'.join(map(str, CONFIG3_SHAPE))} at 1x1x2 mm ->"
        f" {'x'.join(map(str, CONFIG3_OUT))} at 1 mm (median call"
        f" {statistics.median(timed) * 1e3:.1f} ms, calls {[round(t * 1e3, 1) for t in times]}"
        f" ms, warm-up first); resample launches per call {resample}; threefry {draws};"
        f" peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, call, batch, profile, name)
    return totals, batch


def phase_config4(torch, tio, kl, profile: str | None):
    """config4-elastic-inverse: ElasticDeformation and its inverse on B=4
    subjects of a 256^3 ``t1`` and ``seg``; the interior label
    consistency of the round trip, as benchmarks/suite.py:206-209
    computes it."""
    name = "config4-elastic-inverse"
    dev = torch.device(DEVICE)
    shape = (S, S, S)
    batch = make_suite_batch(tio, torch, B, {"t1": 1}, shape, (1, 1, 1), dev, 4)
    seg_in = batch.seg.data.clone()
    call = config4_call(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(torch, kl, call, batch, ("resample",))
    resample, draws = check_path_launches(name, per_call)
    t1, seg = out.t1.data, out.seg.data
    if tuple(t1.shape) != (B, 1, *shape) or t1.device.type != DEVICE:
        fail(f"{name} t1 output {tuple(t1.shape)} on {t1.device}")
    if tuple(seg.shape) != (B, 1, *shape) or seg.dtype != torch.int32:
        fail(f"{name} seg output {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(t1).all()) or any(histories):
        fail(f"{name}: non-finite t1 or histories left {histories}")
    interior = (slice(None), slice(None), *(slice(CONFIG4_MARGIN, -CONFIG4_MARGIN),) * 3)
    consistency = float((seg[interior] == seg_in[interior]).float().mean())
    # the forward alone: the inverse must bring the labels back closer
    tio.seed(0)
    warped = config4_forward(tio)(batch).seg.data
    forward = float((warped[interior] == seg_in[interior]).float().mean())
    del warped
    if not consistency > forward:
        fail(f"{name}: interior label consistency {consistency}, the forward alone {forward}")
    timed = times[WARMUP:]
    print(
        f"{name}: {B * TIMED / sum(timed):.2f} subjects/s over {TIMED} timed calls of"
        f" B={B} x (1 + 1) x {S}^3, forward and inverse (median call"
        f" {statistics.median(timed) * 1e3:.1f} ms, calls {[round(t * 1e3, 1) for t in times]}"
        f" ms, warm-up first); resample launches per call {resample}; threefry {draws};"
        f" interior label consistency (margin {CONFIG4_MARGIN}) {consistency:.6f}, the"
        f" forward alone {forward:.6f}; peak allocated {peak / 2**30:.2f} GiB"
    )
    if profile:
        profile_calls(torch, call, batch, profile, name)
    return totals


def phase_diagonal_timing(torch, np, tio, rs, rk, batch):
    """The resample kernel on config 3's Resample step (a diagonal map,
    2 mm -> 1 mm along k: k_in = k_out / 2 - 0.25) against the plain
    resample, and against its one-call library equivalent,
    ``F.interpolate(trilinear, scale_factor=(1, 1, 2), align_corners=
    False)``: the same map, which clamps at the border where the kernel
    fills, so they are compared off the first and last k slice."""
    dev = torch.device(DEVICE)
    params = tio.Resample(target=1.0).make_params(batch)
    maps, fields, out_shape = target_grids(rs, params, batch.ch.affines[0], B, dev)
    vol = batch.ch.data.contiguous()
    fill, apply_fill = rs._fill_bc(torch.amin(vol, dim=(-3, -2, -1)), B, CONFIG3_C, dev)
    args = (vol, maps, fields, fill, out_shape, "linear", apply_fill)
    got = rk.resample_cuda(*args)
    err = float((got - rs.resample_plain(*args)).abs().max())
    if not err <= KERNEL_ATOL:
        fail(f"resample kernel vs plain on config 3's diagonal map: max abs {err}")

    def library():
        return torch.nn.functional.interpolate(
            vol, scale_factor=(1.0, 1.0, 2.0), mode="trilinear", align_corners=False
        )

    lib_err = float((library()[..., 1:-1] - got[..., 1:-1]).abs().max())
    del got
    if not lib_err <= KERNEL_ATOL:
        fail(f"F.interpolate differs from the kernel off the k borders by {lib_err}")
    order, ms, plain_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), lambda: rs.resample_plain(*args)
    )
    lib_order, _, library_ms = time_pair(
        torch, lambda: rk.resample_cuda(*args), library, plain_reps=20
    )
    voxels = B * math.prod(out_shape)
    # as the resample's bound: the map, 8 corner weights a voxel, 8
    # products and 7 sums a voxel and channel
    work = bound(
        nbytes(vol, maps, fill) + voxels * CONFIG3_C * 4,
        voxels * (point_flops(fields) + 16) + voxels * CONFIG3_C * 15,
    )
    print(
        f"resample on config 3's diagonal map, B={B} x {CONFIG3_C} x"
        f" {'x'.join(map(str, CONFIG3_SHAPE))} -> {'x'.join(map(str, out_shape))} linear:"
        f" kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (k, p, k, p:"
        f" {', '.join(f'{t:.3f}' for t in order)}); max abs {err:.3g}; F.interpolate"
        f" {library_ms:.3f} ms (k, l, k, l: {', '.join(f'{t:.3f}' for t in lib_order)}),"
        f" max abs vs the kernel off the first and last k slice {lib_err:.3g};"
        f" bound {work[0]:.3f} ms ({work[1]})"
    )
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work,
        "library_ms": library_ms,
    }


#: BASELINE.json config 5 (benchmarks/patches_bench.py): 4 subjects, 64^3
#: LabelSampler patches, 8 a subject, a ring of 64, batches of 8, Motion +
#: Ghosting in 2 worker threads; and its hann reassembly: a GridSampler of
#: 64^3 patches overlapping by 16 over one subject, batches of 4. At 256^3
#: (a 1 mm T1), where the bench's 128^3 was sized to feed a TPU
CONFIG5_SUBJECTS, CONFIG5_SHAPE, CONFIG5_PATCH = 4, (S, S, S), 64
CONFIG5_RING, CONFIG5_PER_VOLUME, CONFIG5_BATCH, CONFIG5_WORKERS = 64, 8, 8, 2
CONFIG5_WARMUP, CONFIG5_TIMED, CONFIG5_SEED = 2, 3, 0
CONFIG5B_OVERLAP, CONFIG5B_BATCH, CONFIG5B_TIMED = 16, 4, 3
#: the JAX package's own hann reassembly tolerance
#: (tests/test_patch_pipeline.py, TestAggregator.test_hann_roundtrip)
HANN_RTOL, HANN_ATOL = 1e-3, 1e-4
#: the aggregator on the card against the CPU: the same adds in the same
#: order, an ulp apart at most where the card contracts a product
AGGREGATOR_ATOL = 1e-6


class Recorder:
    """A Queue transform: runs ``transform`` and keeps each output's
    history (transform names), from whichever thread prepared it."""

    def __init__(self, transform):
        self.transform = transform
        self.histories: list[list[str]] = []

    def __call__(self, subject):
        out = self.transform(subject)
        self.histories.append([h.name for h in out.applied_transforms])
        return out

    def motion_kept(self) -> int:
        return sum("Motion" in names for names in self.histories)


def config5_subjects(tio, torch, n, shape, device, seed):
    """``n`` subjects of a float32 ``t1`` in [0, 1) and the int32 block
    ``seg`` of benchmarks/patches_bench.py:30-31, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    subjects = []
    for sid in range(n):
        t1 = torch.rand((1, *shape), generator=gen, device=device)
        subjects.append(tio.Subject(
            t1=tio.ScalarImage(t1), seg=tio.LabelMap(block_seg(torch, shape, device)), sid=sid,
        ))
    return subjects


def config5_queue(tio, subjects, patch, workers, ring=CONFIG5_RING, per_volume=CONFIG5_PER_VOLUME):
    return tio.Queue(
        subjects,
        tio.LabelSampler(patch_size=patch, label_name="seg"),
        max_length=ring,
        patches_per_volume=per_volume,
        num_workers=workers,
        transform=Recorder(kspace_pipeline(tio)),
    )


def patch_centres(batch, n, patch, name):
    """The ``seg`` voxel at each patch's centre (on the card, not read
    yet), after checking the batch is (n, 1, patch^3) t1 and seg there."""
    t1, seg = batch.images["t1"].data, batch.images["seg"].data
    shape = (n, 1, patch, patch, patch)
    if tuple(t1.shape) != shape or tuple(seg.shape) != shape or t1.device.type != DEVICE:
        fail(f"{name}: batch of {tuple(t1.shape)} / {tuple(seg.shape)} on {t1.device}")
    c = patch // 2
    return seg[:, 0, c, c, c]


def batch_locations(batch):
    """Each patch's subject and corner, from a batch's metadata."""
    return [
        (sid, tuple(loc.index))
        for sid, loc in zip(batch.metadata["sid"], batch.metadata["patch_location"], strict=True)
    ]


def check_centres(torch, centres, name):
    """LabelSampler's contract: every patch's centre voxel is labelled."""
    if not bool((torch.cat(centres) > 0).all()):
        fail(f"{name}: a patch centre is not labelled")


def phase_small_patches(torch, np, tio, tr, kl):
    """The patch layer on small inputs, card against CPU: config 5's Queue
    (``device_batches``), a GridSampler -> PatchAggregator pass in each
    mode, Spike, and ``key_randint``'s words."""
    started = time.perf_counter()
    import random

    shape, patch = (48, 48, 48), 16
    runs = {}
    for device in ("cpu", DEVICE):
        previous = tio.set_default_device(device)
        try:
            subjects = config5_subjects(tio, torch, 2, shape, "cpu", 5)
            for subject in subjects:
                subject.to(device)
            queue = config5_queue(tio, subjects, patch, 0, ring=12, per_volume=6)
            random.seed(4)
            tio.seed(4)
            before = kl.LAUNCHES["resample_coords"]
            batches = list(queue.device_batches(batch_size=4, epochs=2))
            runs[device] = (batches, queue.transform, kl.LAUNCHES["resample_coords"] - before)
        finally:
            tio.set_default_device(previous)
    (cpu, cpu_rec, _), (gpu, gpu_rec, launched) = runs["cpu"], runs[DEVICE]
    if cpu_rec.histories != gpu_rec.histories or not gpu_rec.motion_kept():
        fail(f"small Queue: histories {cpu_rec.histories} (cpu), {gpu_rec.histories} (cuda)")
    if launched != gpu_rec.motion_kept():
        fail(f"small Queue: {launched} dense resample launches, Motion kept"
             f" {gpu_rec.motion_kept()} times")
    err = 0.0
    if len(cpu) != len(gpu) or not gpu:
        fail(f"small Queue: {len(cpu)} batches on the cpu, {len(gpu)} on the card")
    for a, b in zip(cpu, gpu):
        check_centres(torch, [patch_centres(b, 4, patch, "small Queue")], "small Queue")
        err = max(err, float((b.images["t1"].data.cpu() - a.images["t1"].data).abs().max()))
        same = torch.equal(b.images["seg"].data.cpu(), a.images["seg"].data) and all(
            x.to_json() == y.to_json()
            for x, y in zip(a.metadata["patch_location"], b.metadata["patch_location"])
        ) and all(
            np.array_equal(x.data, y.data)
            for name in ("t1", "seg")
            for x, y in zip(a.images[name].affines, b.images[name].affines)
        )
        if not same or not err <= SLICE_ATOL:
            fail(f"small Queue: a batch differs from the CPU path (t1 max abs {err})")
    print(
        f"small Queue (2 x 48^3 t1 + seg, LabelSampler 16^3, Motion + Ghosting,"
        f" device_batches of 4) cuda vs cpu: {len(gpu)} batches, t1 max abs {err:.3g}"
        f" (limit {SLICE_ATOL}), seg, locations and affines equal; histories"
        f" {gpu_rec.histories}; dense resample launches {launched}"
    )
    agg_err = {}
    volume = torch.rand((2, *shape), generator=torch.Generator().manual_seed(8))
    for mode in ("crop", "average", "hann"):
        outs = []
        for device in ("cpu", DEVICE):
            subject = tio.Subject(t1=tio.ScalarImage(volume.to(device)))
            sampler = tio.GridSampler(subject, patch_size=patch, patch_overlap=4)
            agg = tio.PatchAggregator(shape, overlap_mode=mode, patch_overlap=4)
            for batch in tio.SubjectsLoader(sampler, batch_size=5):
                agg.add_batch(batch.images["t1"].data, batch.metadata["patch_location"])
            outs.append(agg.get_output(device=True))
        if outs[1].device.type != DEVICE:
            fail(f"aggregator ({mode}): output on {outs[1].device}")
        agg_err[mode] = float((outs[1].cpu() - outs[0]).abs().max())
        recon = float((outs[1].cpu() - volume).abs().max())
        if not agg_err[mode] <= AGGREGATOR_ATOL or not recon <= HANN_ATOL + HANN_RTOL:
            fail(f"aggregator ({mode}): cuda vs cpu {agg_err[mode]}, vs the input {recon}")
    print(f"small GridSampler -> PatchAggregator (2 x 48^3, 16^3 overlapping by 4) cuda vs"
          f" cpu: max abs {agg_err} (limit {AGGREGATOR_ATOL})")
    from torchio_tpu_torch.data.sampler import xla_cumsum

    # non-dyadic weights: the samplers' CDF is summed in XLA:CPU's order with
    # plain float32 adds, so the card's corners equal the CPU's
    corners = {}
    labels = suite_labels(torch, shape, "cpu")
    samplers = {
        "LabelSampler {0: 0.1, 1: 0.3, 2: 0.7, 3: 0.9}": lambda: tio.LabelSampler(
            patch_size=patch, label_name="seg",
            label_probabilities={0: 0.1, 1: 0.3, 2: 0.7, 3: 0.9},
        ),
        "WeightedSampler on t1": lambda: tio.WeightedSampler(patch_size=patch, probability_map="t1"),
    }
    for device in ("cpu", DEVICE):
        subject = tio.Subject(
            t1=tio.ScalarImage(volume[:1].to(device)), seg=tio.LabelMap(labels.to(device))
        )
        for name, make in samplers.items():
            tio.seed(13)
            corners[device, name] = [loc.index for loc in make().sample_locations(subject, 400)]
    for name in samplers:
        if corners["cpu", name] != corners[DEVICE, name]:
            fail(f"{name}: the card's corners differ from the CPU's")
    weights = torch.rand(S**3, generator=torch.Generator().manual_seed(14))
    cdf_cpu = xla_cumsum(weights)
    cdf_gpu = xla_cumsum(weights.to(DEVICE)).cpu()
    if not torch.equal(cdf_cpu.view(torch.int32), cdf_gpu.view(torch.int32)):
        fail(f"xla_cumsum of {S}^3 weights: the card's bits differ from the CPU's")
    print(f"samplers on non-dyadic weights ({', '.join(samplers)}; 400 corners each) cuda vs"
          f" cpu: equal; the CDF of {S}^3 float32 weights bit-equal")
    cpu_out, gpu_out = run_on_both(
        tio, lambda: make_batch(tio, torch, 2, (40, 44, 48), "cpu", 9),
        lambda t: t.Spike(num_spikes=(1, 3), intensity=(1, 3)), 6,
    )
    spike_err = float((gpu_out.t1.data.cpu() - cpu_out.t1.data).abs().max())
    print(f"small Spike (2 x 40x44x48) cuda vs cpu: max abs {spike_err:.3g} (limit {SLICE_ATOL})")
    if not spike_err <= SLICE_ATOL:
        fail(f"Spike differs from the CPU path by {spike_err}")
    before = kl.LAUNCHES["threefry_bits"]
    spans = ((0, 1), (0, 64), (0, 1000), (-7, 12), (0, 2**31 - 1))
    for lo, hi in spans:
        for n in (8, 4097):
            key = tr.prng_key(lo * 31 + n)
            got = tr.key_randint(key, (n,), lo, hi, device=DEVICE)
            want = tr.key_randint(key, (n,), lo, hi, device="cpu")
            if not torch.equal(got.cpu(), want):
                fail(f"key_randint [{lo}, {hi}) x {n}: the card's draw differs")
    launched = kl.LAUNCHES["threefry_bits"] - before
    if launched != 2 * len(spans):
        fail(f"key_randint: {launched} threefry bits launches for {2 * len(spans)} draws")
    print(f"key_randint on the card vs cpu: equal on spans {spans} (8 and 4,097 draws),"
          f" one threefry bits launch a draw; the patch layer's small checks took"
          f" {time.perf_counter() - started:.1f} s")


def phase_config5_queue(torch, tio, kl, profile: str | None):
    """config5-queue-labelsampler: benchmarks/patches_bench.py's
    bench_queue_device on the card (``Queue.device_batches``), then its
    bench_queue (``SubjectsLoader`` over the Queue) once beside it."""
    started = time.perf_counter()
    name = "config5-queue-labelsampler"
    dev = torch.device(DEVICE)
    subjects = config5_subjects(tio, torch, CONFIG5_SUBJECTS, CONFIG5_SHAPE, dev, 0)
    queue = config5_queue(tio, subjects, CONFIG5_PATCH, CONFIG5_WORKERS)
    recorder = queue.transform
    centres, locations = [], []

    def epoch(times=None):
        t0 = time.perf_counter()
        n = 0
        for batch in queue.device_batches(batch_size=CONFIG5_BATCH):
            batch.images["t1"].data.sum().item()  # a device-side consumer
            centres.append(patch_centres(batch, CONFIG5_BATCH, CONFIG5_PATCH, name))
            locations.append(batch_locations(batch))
            n += batch.batch_size
            if times is not None:
                times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        return n

    random.seed(CONFIG5_SEED)  # the Queue's subject shuffle
    tio.seed(CONFIG5_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kl.reset_launches()
    for _ in range(CONFIG5_WARMUP):
        epoch()
    batch_times: list[float] = []
    t0 = time.perf_counter()
    patches = sum(epoch(batch_times) for _ in range(CONFIG5_TIMED))
    wall = time.perf_counter() - t0
    launches = {k: kl.LAUNCHES[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    prepared = (CONFIG5_WARMUP + CONFIG5_TIMED) * CONFIG5_SUBJECTS
    if len(recorder.histories) != prepared:
        fail(f"{name}: {len(recorder.histories)} subjects prepared, expected {prepared}")
    kept = recorder.motion_kept()
    if not kept or launches["resample_coords"] != kept:
        fail(f"{name}: {launches['resample_coords']} dense resample launches, Motion kept"
             f" {kept} times in {prepared} subjects")
    others = {k: v for k, v in launches.items() if v and k != "resample_coords"}
    if others:
        fail(f"{name}: launched kernels off its path: {others}")
    expected = CONFIG5_TIMED * (CONFIG5_SUBJECTS * CONFIG5_PER_VOLUME // CONFIG5_BATCH)
    if len(batch_times) * CONFIG5_BATCH != patches or len(batch_times) != expected:
        fail(f"{name}: {len(batch_times)} timed batches, expected {expected}")
    loader_patches = 0
    for i in range(CONFIG5_WARMUP + CONFIG5_TIMED):
        if i == CONFIG5_WARMUP:
            t1 = time.perf_counter()
            loader_patches = 0
        for batch in tio.SubjectsLoader(queue, batch_size=CONFIG5_BATCH):
            batch.images["t1"].data.sum().item()
            centres.append(patch_centres(batch, CONFIG5_BATCH, CONFIG5_PATCH, name))
            loader_patches += batch.batch_size
    loader_wall = time.perf_counter() - t1
    check_centres(torch, centres, name)
    print(
        f"{name}: {patches / wall:.2f} patches/s over {CONFIG5_TIMED} timed epochs of"
        f" Queue.device_batches ({CONFIG5_SUBJECTS} subjects of 1 x {CONFIG5_SHAPE[0]}^3 t1 +"
        f" int32 seg, LabelSampler {CONFIG5_PATCH}^3, {CONFIG5_PER_VOLUME} a subject, ring"
        f" {CONFIG5_RING}, batches of {CONFIG5_BATCH}, {CONFIG5_WORKERS} workers; after"
        f" {CONFIG5_WARMUP} warm-up epochs); median batch"
        f" {statistics.median(batch_times) * 1e3:.2f} ms (batches"
        f" {[round(t * 1e3, 1) for t in batch_times]} ms); dense resample launches"
        f" {launches['resample_coords']} = subjects that kept Motion ({kept} of {prepared});"
        f" peak allocated {peak / 2**30:.2f} GiB; SubjectsLoader over the Queue:"
        f" {loader_patches / loader_wall:.2f} patches/s ({CONFIG5_TIMED} epochs after"
        f" {CONFIG5_WARMUP}); the phase took {time.perf_counter() - started:.1f} s"
    )
    device_locations = list(locations)
    if profile:
        profile_calls(torch, lambda _: epoch(), None, profile, f"{name} (an epoch a call)")
    return launches, device_locations


def phase_config5_aggregator(torch, np, tio, profile: str | None):
    """config5b-grid-hann-aggregator: benchmarks/patches_bench.py's
    bench_aggregator(device_output=True) on the card (GridSampler ->
    SubjectsLoader -> an identity model -> hann PatchAggregator ->
    ``get_output(device=True)``), and the pull to the host beside it."""
    started = time.perf_counter()
    name = "config5b-grid-hann-aggregator"
    dev = torch.device(DEVICE)
    subject = config5_subjects(tio, torch, 1, CONFIG5_SHAPE, dev, 1)[0]
    sampler = tio.GridSampler(
        subject, patch_size=CONFIG5_PATCH, patch_overlap=CONFIG5B_OVERLAP
    )
    loader = tio.SubjectsLoader(sampler, batch_size=CONFIG5B_BATCH)

    def run_pass(device_output=True):
        agg = tio.PatchAggregator(subject.spatial_shape, overlap_mode="hann")
        for batch in loader:
            agg.add_batch(batch.images["t1"].data, batch.metadata["patch_location"])
        out = agg.get_output(device=device_output)
        torch.cuda.synchronize()
        return out

    run_pass()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(CONFIG5B_TIMED):
        t0 = time.perf_counter()
        out = run_pass()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    volume = subject.t1.data
    if tuple(out.shape) != tuple(volume.shape) or out.device.type != DEVICE:
        fail(f"{name}: output {tuple(out.shape)} on {out.device}")
    err = (out - volume).abs()
    if not bool((err <= HANN_ATOL + HANN_RTOL * volume.abs()).all()):
        fail(f"{name}: output differs from the input by up to {float(err.max())}")
    host_times = []
    for _ in range(CONFIG5B_TIMED):
        t0 = time.perf_counter()
        host = run_pass(device_output=False)
        host_times.append(time.perf_counter() - t0)
    if not np.allclose(host, volume.cpu().numpy(), rtol=HANN_RTOL, atol=HANN_ATOL):
        fail(f"{name}: the host output differs from the input")
    pull = []
    for _ in range(CONFIG5B_TIMED):
        t0 = time.perf_counter()
        out.cpu().numpy()
        pull.append(time.perf_counter() - t0)
    n = len(sampler)
    print(
        f"{name}: {n / statistics.median(times):.2f} patches/s (median pass"
        f" {statistics.median(times) * 1e3:.1f} ms, passes {[round(t * 1e3, 1) for t in times]}"
        f" ms after a warm-up) for {n} patches of {CONFIG5_PATCH}^3 overlapping by"
        f" {CONFIG5B_OVERLAP} over 1 x {CONFIG5_SHAPE[0]}^3, batches of {CONFIG5B_BATCH},"
        f" get_output(device=True); max abs vs the input {float(err.max()):.3g}; peak allocated"
        f" {peak / 2**30:.2f} GiB; with get_output() to host numpy:"
        f" {n / statistics.median(host_times):.2f} patches/s (median pass"
        f" {statistics.median(host_times) * 1e3:.1f} ms), the pull of the"
        f" {out.numel() * 4 / 2**20:.0f} MiB volume alone {statistics.median(pull) * 1e3:.2f} ms;"
        f" the phase took {time.perf_counter() - started:.1f} s"
    )
    if profile:
        profile_calls(torch, lambda _: run_pass(), None, profile, f"{name} (a pass a call)")


def phase_ring_sample_timing(torch, tr, tk, kl):
    """The threefry kernel's bits mode on its path, ``RingPatchBuffer.
    sample`` (``key_randint``: two segments in one launch) at config 5's
    ring and batch: launches counted around one call, then the kernel
    against the plain words at the draw's shape."""
    from torchio_tpu_torch.ops.patches import RingPatchBuffer

    dev = torch.device(DEVICE)
    ring = RingPatchBuffer(CONFIG5_RING, (1, *(CONFIG5_PATCH,) * 3), device=dev)
    ring.push(torch.rand((CONFIG5_RING, 1, *(CONFIG5_PATCH,) * 3), device=dev))
    torch.cuda.synchronize()
    kl.reset_launches()
    drawn = ring.sample(CONFIG5_BATCH, seed=11)
    torch.cuda.synchronize()
    launches = kl.LAUNCHES["threefry_bits"]
    if launches != 1 or tuple(drawn.shape) != (CONFIG5_BATCH, 1, *(CONFIG5_PATCH,) * 3):
        fail(f"RingPatchBuffer.sample: {launches} threefry bits launches, {tuple(drawn.shape)}")
    keys = tr.split(tr.prng_key(11))
    counts = [CONFIG5_BATCH, CONFIG5_BATCH]

    def kernel():
        return tk.threefry_segments_cuda(keys, counts, None, dev, normal=False)

    def plain():
        return torch.cat([tr.bits_plain(k, 0, c, dev) for k, c in zip(keys, counts)])

    got = kernel().to(torch.int64) & tr.MASK32
    err = float((got - plain()).abs().max())
    if err != 0:
        fail(f"threefry bits at the ring's draw: max abs {err}")
    order, ms, plain_ms = time_pair(torch, kernel, plain, kernel_reps=200, plain_reps=20)
    n = sum(counts)
    work = bound(4 * n, n * 73)  # writes 4 bytes a word; 73 integer operations a word
    print(
        f"threefry bits on RingPatchBuffer.sample ({CONFIG5_BATCH} rows of a {CONFIG5_RING}-patch"
        f" ring: 2 x {CONFIG5_BATCH} words in one launch): kernel {ms:.4f} ms, plain"
        f" {plain_ms:.4f} ms (k, p, k, p: {', '.join(f'{t:.4f}' for t in order)}); bound"
        f" {work[0]:.2e} ms ({work[1]}); launches a call {launches}"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": work}, launches



#: docs/tutorials/augmentation.md:82-91, the composition policy: a B=4
#: batch of 256^3 ``t1`` + int32 block ``seg``, then its per-element
#: inverse; and the k-space OneOf of :48-52 on the same subjects
POLICY_SEED, ONEOF_SEED = 0, 0
#: history keys that hold statistics of the data: their floats come from
#: sums in another order on the card than on the CPU
DATA_STATS = ("in_ranges", "stats")


def policy_pipeline(tio):
    """``docs/tutorials/augmentation.md:82-91``."""
    return tio.Compose(
        [
            tio.Flip(axes=(0,), p=0.5),
            tio.Spatial(scales=(0.95, 1.05), degrees=5.0),
            tio.SomeOf(
                [tio.BiasField(), tio.Blur(std=(0.1, 0.8)), tio.Gamma()],
                num_transforms=(0, 2),
            ),
            tio.RescaleIntensity(out_min=0.0, out_max=1.0),
        ]
    )


def kspace_oneof(tio):
    """``docs/tutorials/augmentation.md:48-52``."""
    return tio.OneOf({tio.Motion(): 0.5, tio.Ghosting(): 0.3, tio.Spike(): 0.2})


def brats_preprocess(tio, fuse=True):
    """The fused preprocessing chain: its members are those of
    ``docs/concepts/performance.md:144-150``."""
    return tio.Compose(
        [
            tio.Clamp(out_min=0.0),
            tio.ZNormalization(masking_method="seg"),
            tio.Mask(masking_method="seg", labels=[1, 2, 4]),
        ],
        fuse=fuse,
    )


class PolicyCall:
    """The policy forward, then ``apply_inverse_transform()``; keeps each
    call's per-element histories (transform names) and forward output."""

    def __init__(self, tio):
        self.pipeline = policy_pipeline(tio)
        self.elements: list[list[list[str]]] = []
        self.forward = None

    def __call__(self, batch):
        self.forward = self.pipeline(batch)
        if self.forward._per_element_history is None:
            fail("policy-someof: the SomeOf left no per-element histories")
        self.elements.append(
            [[h.name for h in s.applied_transforms] for s in self.forward.unbatch()]
        )
        return self.forward.apply_inverse_transform(warn=False)


class OneOfCall:
    """The k-space OneOf, keeping each call's per-element histories and
    Motion's moves (one dense resample launch a move of an element)."""

    def __init__(self, tio):
        self.pipeline = kspace_oneof(tio)
        self.elements: list[list[list[str]]] = []
        self.moves: list[int] = []

    def __call__(self, batch):
        out = self.pipeline(batch)
        records = [h for s in out.unbatch() for h in s.applied_transforms]
        self.elements.append([[h.name for h in s.applied_transforms] for s in out.unbatch()])
        self.moves.append(sum(len(h.params["transforms"]) for h in records if h.name == "Motion"))
        return out


def policy_launches(elements):
    """The resample and threefry launches a policy call implies: Spatial
    resamples ``t1`` and ``seg`` once batch-wide and once more in each
    element's inverse; BiasField draws one field on its element (a batch
    of one) and its inverse draws it again."""
    return {
        "resample": 2 + 2 * sum("Spatial" in names for names in elements),
        "threefry_normal": 2 * sum("BiasField" in names for names in elements),
    }


def json_close(got, want, stats=False) -> bool:
    """Equal history trees, floats under DATA_STATS keys within SLICE_ATOL
    (relative above 1)."""
    if isinstance(want, dict):
        return isinstance(got, dict) and sorted(got) == sorted(want) and all(
            json_close(got[k], want[k], stats or k in DATA_STATS) for k in want
        )
    if isinstance(want, (list, tuple)):
        return isinstance(got, (list, tuple)) and len(got) == len(want) and all(
            json_close(g, w, stats) for g, w in zip(got, want)
        )
    if stats and isinstance(want, float):
        return isinstance(got, float) and abs(got - want) <= SLICE_ATOL * max(1.0, abs(want))
    return got == want


def element_histories(batch):
    return [
        [(h.name, h.params, h.include, h.exclude) for h in s.applied_transforms]
        for s in batch.unbatch()
    ]


def element_ties(torch, tio, rs, params, affine, shape, earlier=None, inverse=False):
    """(1, 1, *shape) near ties of one element's (sliced) Spatial record,
    forward or its inverse (see ``nearest_ties``)."""
    from torchio_tpu_torch.transforms.spatial.spatial import _build_grid

    if inverse:
        spatial = object.__new__(tio.Spatial).inverse(params)
        matrix, points, first = spatial.affine_matrix, spatial.control_points, spatial.affine_first
    else:
        matrix, points, first = (
            params["affine_matrix"], params["control_points"], params["affine_first"]
        )
    grid = _build_grid(
        input_affine=affine, output_shape=shape, output_affine=affine, affine_matrix=matrix,
        control_points=points, max_displacement=None, affine_first=first,
    )
    maps, fields = rs._marshal_maps([grid[0]], [grid[1]], "cpu")
    return nearest_ties(torch, rs, maps, fields, shape, earlier)


def policy_ties(torch, tio, rs, forward, shape):
    """(B, 1, *shape) near ties of each element's seg after the forward
    and after the inverse (Spatial's inverse reads the forward's ties;
    Flip's inverse flips them)."""
    affine = forward.seg.affines[0]
    fwd, back = [], []
    for subject in forward.unbatch():
        records = {h.name: h.params for h in subject.applied_transforms}
        ties = element_ties(torch, tio, rs, records["Spatial"], affine, shape)
        fwd.append(ties)
        ties = element_ties(
            torch, tio, rs, records["Spatial"], affine, shape, earlier=ties, inverse=True
        )
        if "Flip" in records:
            ties = torch.flip(ties, [2 + a for a in records["Flip"]["axes"]])
        back.append(ties)
    return torch.cat(fwd), torch.cat(back)


def both_devices(tio, make, make_pipeline, seed):
    """A new ``make_pipeline()`` on a batch from ``make`` on the CPU and on
    the card, from one seed: ((cpu output, card output), (cpu pipeline,
    card pipeline), the card run's launches)."""
    import torch
    from torchio_tpu_torch.ops import kernel_lib as kl

    # the first multithreaded torch.exp of a process has returned results
    # off by up to 2e-4 on PyTorch's CPU build (2.13.0+cpu); warm the
    # CPU thread pool before the CPU path is the reference
    torch.exp(torch.zeros(1 << 20))
    outs, pipelines, launched = [], [], {}
    for device in ("cpu", DEVICE):
        batch = make().to(device)
        tio.seed(seed)
        pipelines.append(make_pipeline())
        before = dict(kl.LAUNCHES)
        outs.append(pipelines[-1](batch))
        launched = {k: kl.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    return outs, pipelines, launched


def phase_small_policy(torch, np, tio, rs, kl):
    """policy-someof on a small batch, forward and per-element inverse:
    card against the CPU path."""
    shape = (40, 44, 48)
    (cpu, gpu), calls, launched = both_devices(
        tio,
        lambda: make_suite_batch(tio, torch, B, {"t1": 1}, shape, (1, 1, 1), "cpu", 41),
        lambda: PolicyCall(tio), 42,
    )
    fwd_cpu, fwd_gpu = calls[0].forward, calls[1].forward
    if not json_close(element_histories(fwd_gpu), element_histories(fwd_cpu)):
        fail("small policy: the card's per-element histories differ from the CPU's")
    elements = calls[0].elements[0]
    want = policy_launches(elements)
    if any(launched[k] != n for k, n in want.items()):
        fail(f"small policy: launches {launched}, the draws {elements} imply {want}")
    err = max(
        float((g.t1.data.cpu() - c.t1.data).abs().max())
        for g, c in ((fwd_gpu, fwd_cpu), (gpu, cpu))
    )
    ties_fwd, ties_back = policy_ties(torch, tio, rs, fwd_cpu, shape)
    off = [
        int(((g.seg.data.cpu() != c.seg.data) & ~ties).sum())
        for g, c, ties in ((fwd_gpu, fwd_cpu, ties_fwd), (gpu, cpu, ties_back))
    ]
    print(
        f"small policy-someof ({B} x (1 + 1) x 40x44x48, forward and per-element inverse)"
        f" cuda vs cpu: t1 max abs {err:.3g} (limit {SLICE_ATOL}); seg voxels off near"
        f" ties {off}; per-element histories {elements}; launches {want}"
    )
    if not err <= SLICE_ATOL or any(off):
        fail("the small policy differs from the CPU path")


def phase_small_kspace_oneof(torch, tio, kl):
    """kspace-oneof on a small batch: card against the CPU path."""
    shape = (40, 44, 48)
    (cpu, gpu), calls, launched = both_devices(
        tio, lambda: make_kspace_batch(tio, torch, B, shape, "cpu", 7),
        lambda: OneOfCall(tio), 1,
    )
    if not json_close(element_histories(gpu), element_histories(cpu)):
        fail("small k-space OneOf: the card's per-element histories differ from the CPU's")
    elements, moves = calls[0].elements[0], calls[0].moves[0]
    if not moves or launched["resample_coords"] != moves or launched["threefry_normal"]:
        fail(f"small k-space OneOf: launches {launched}, histories {elements}, {moves} moves")
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    seg_in = block_seg(torch, shape, "cpu").expand(B, 1, *shape)
    seg_ok = torch.equal(gpu.seg.data.cpu(), seg_in) and torch.equal(cpu.seg.data, seg_in)
    print(
        f"small kspace-oneof ({B} x 40x44x48) cuda vs cpu: t1 max abs {err:.3g} (limit"
        f" {SLICE_ATOL}); seg untouched {seg_ok}; per-element histories {elements};"
        f" dense resample launches {launched['resample_coords']} ({moves} moves)"
    )
    if not err <= SLICE_ATOL or not seg_ok:
        fail("the small k-space OneOf differs from the CPU path")


def phase_small_brats_preprocess(torch, tio, kl):
    """brats-preprocess-fused on a small batch: card against the CPU path,
    fused against unfused on the card."""
    shape = (50, 52, 48)
    (cpu, gpu), _, launched = both_devices(
        tio, lambda: make_brats_batch(tio, torch, 2, shape, "cpu", 5),
        lambda: brats_preprocess(tio), 0,
    )
    tio.seed(0)
    unfused = brats_preprocess(tio, fuse=False)(
        make_brats_batch(tio, torch, 2, shape, "cpu", 5).to(DEVICE)
    )
    history = [(h.name, h.params) for h in gpu.applied_transforms]
    if not json_close(history, [(h.name, h.params) for h in cpu.applied_transforms]):
        fail(f"small brats preprocess: histories {history} (card)")
    if [(h.name, h.params) for h in unfused.applied_transforms] != history:
        fail("small brats preprocess: fused and unfused histories differ on the card")
    err = float((gpu.mri.data.cpu() - cpu.mri.data).abs().max())
    fused_equal = torch.equal(unfused.mri.data, gpu.mri.data)
    print(
        f"small brats-preprocess-fused (2 x (4 + 1) x 50x52x48) cuda vs cpu: mri max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); fused equal to unfused on the card {fused_equal};"
        f" kernel launches {sum(launched.values())}; stats {history[1][1]['stats']}"
    )
    if not err <= SLICE_ATOL or not fused_equal or any(launched.values()):
        fail("the small brats preprocess differs from the CPU path or its unfused run")


def report_path(name, times, peak, per_call, kernels, smi, unit, count, warmup=WARMUP):
    """One line of a full-width path: rate, median call, launches, peak."""
    timed = times[warmup:]
    launches = {k: [c[k] for c in per_call] for k in kernels}
    print(
        f"{name}: {count * len(timed) / sum(timed):.2f} {unit}/s over {len(timed)} timed calls"
        f" (median call {statistics.median(timed) * 1e3:.1f} ms, calls"
        f" {[round(t * 1e3, 1) for t in times]} ms, warm-up first); launches per call"
        f" {launches}; peak allocated {peak / 2**30:.2f} GiB; card {smi}"
    )


def profile_same_draws(torch, tio, seed, call, batch, profile, name):
    """Device time a call (the profiler, two calls) and the idle share
    against the wall time of two unprofiled calls of the same draws (the
    work of these paths depends on what each element draws)."""
    tio.seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        call(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    tio.seed(seed)
    device_ms = profile_calls(torch, call, batch, profile, name)
    print(
        f"{name}: device {device_ms:.3f} ms a call, wall {wall_ms:.1f} ms a call over the"
        f" same two draws, idle {1 - device_ms / wall_ms:.0%}"
    )


def phase_policy(torch, tio, kl, smi, profile: str | None):
    """policy-someof: the docs' composition policy on B=4 subjects of a
    256^3 ``t1`` and an int32 block ``seg``, then the batch's
    ``apply_inverse_transform()`` (per element)."""
    name = "policy-someof"
    shape = (S, S, S)
    batch = make_suite_batch(tio, torch, B, {"t1": 1}, shape, (1, 1, 1), torch.device(DEVICE), 11)
    call = PolicyCall(tio)
    tio.seed(POLICY_SEED)
    out, times, per_call, totals, peak, _ = drive(torch, kl, call, batch, ("resample",))
    for elements, launched in zip(call.elements, per_call):
        want = policy_launches(elements)
        others = {k: n for k, n in launched.items() if k not in want and n}
        if any(launched[k] != n for k, n in want.items()) or others:
            fail(f"{name}: launches {launched}, the draws {elements} imply {want}")
    if sum("BiasField" in n for elements in call.elements for n in elements) == 0:
        fail(f"{name}: no element drew BiasField in {call.elements}")
    fwd = call.forward
    for data, what in ((fwd.t1.data, "forward"), (out.t1.data, "inverse")):
        if tuple(data.shape) != (B, 1, *shape) or data.device.type != DEVICE:
            fail(f"{name} {what} t1 {tuple(data.shape)} on {data.device}")
        if not bool(torch.isfinite(data).all()):
            fail(f"{name} {what} t1 has non-finite values")
    low, high = float(fwd.t1.data.min()), float(fwd.t1.data.max())
    values = set(torch.unique(out.seg.data).tolist())
    if low < 0.0 or high > 1.0 or not values <= {0, 1, 2, 3} or out.seg.data.dtype != torch.int32:
        fail(f"{name}: t1 in [{low}, {high}], seg labels {sorted(values)} {out.seg.data.dtype}")
    report_path(name, times, peak, per_call, ("resample", "threefry_normal"), smi, "subjects", B)
    print(f"{name}: per-element histories of each call {call.elements}")
    if profile:
        profile_same_draws(torch, tio, POLICY_SEED, call, batch, profile, name)
    return totals


def phase_kspace_oneof(torch, tio, kl, smi, profile: str | None):
    """kspace-oneof: the docs' k-space OneOf, per instance, on B=4
    subjects of a 256^3 ``t1`` and an int32 ``seg``."""
    name = "kspace-oneof"
    shape = (S, S, S)
    batch = make_kspace_batch(tio, torch, B, shape, torch.device(DEVICE), 0)
    seg_in = batch.seg.data.clone()
    call = OneOfCall(tio)
    tio.seed(ONEOF_SEED)
    out, times, per_call, totals, peak, _ = drive(torch, kl, call, batch, ())
    for elements, moves, launched in zip(call.elements, call.moves, per_call):
        others = {k: n for k, n in launched.items() if k != "resample_coords" and n}
        if launched["resample_coords"] != moves or others:
            fail(f"{name}: launches {launched}, histories {elements}, {moves} moves")
    if not sum(call.moves):
        fail(f"{name}: no element drew Motion in {call.elements}")
    t1 = out.t1.data
    if tuple(t1.shape) != (B, 1, *shape) or t1.device.type != DEVICE:
        fail(f"{name} t1 output {tuple(t1.shape)} on {t1.device}")
    if not bool(torch.isfinite(t1).all()):
        fail(f"{name} t1 output has non-finite values")
    if not torch.equal(out.seg.data, seg_in) or not torch.equal(batch.seg.data, seg_in):
        fail(f"{name} seg output is not the input label map")
    report_path(name, times, peak, per_call, ("resample_coords",), smi, "volumes", B)
    print(f"{name}: per-element histories of each call {call.elements}; Motion's moves"
          f" (one dense resample launch each) {call.moves}")
    if profile:
        profile_same_draws(torch, tio, ONEOF_SEED, call, batch, profile, name)
    return totals


def phase_brats_preprocess(torch, tio, kl, smi, profile: str | None):
    """brats-preprocess-fused: Clamp, ZNormalization and Mask fused on the
    brats cell's B=4 subjects (4 x 240x240x155 ``mri``, int32 ``seg``);
    no hand-written kernel; fused equal to unfused."""
    name = "brats-preprocess-fused"
    batch = make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, torch.device(DEVICE), 0)
    pipeline = brats_preprocess(tio)
    tio.seed(0)
    out, times, per_call, totals, peak, histories = drive(torch, kl, pipeline, batch, ())
    if any(any(call.values()) for call in per_call):
        fail(f"{name}: a hand-written kernel launched: {per_call}")
    if any(h != ["Clamp", "Standardize", "Mask"] for h in histories):
        fail(f"{name}: histories {histories}")
    mri = out.mri.data
    if tuple(mri.shape) != (BRATS_B, BRATS_C, *BRATS_SHAPE) or mri.device.type != DEVICE:
        fail(f"{name} mri output {tuple(mri.shape)} on {mri.device}")
    if not bool(torch.isfinite(mri).all()):
        fail(f"{name} mri output has non-finite values")
    outside = (batch.seg.data == 0).expand_as(mri)
    if bool((mri[outside] != 0).any()):
        fail(f"{name}: a voxel outside the labels is not 0")
    tio.seed(0)
    unfused = brats_preprocess(tio, fuse=False)(batch)
    if not torch.equal(unfused.mri.data, mri) or [
        (h.name, h.params) for h in unfused.applied_transforms
    ] != [(h.name, h.params) for h in out.applied_transforms]:
        fail(f"{name}: the fused run differs from the unfused one")
    del unfused
    report_path(name, times, peak, per_call, (), smi, "subjects", BRATS_B)
    print(f"{name}: fused equal to unfused on the card; stats {out.applied_transforms[1].params}")
    if profile:
        profile_same_draws(torch, tio, 0, pipeline, batch, profile, name)
    return totals


# --- the rest of the transform zoo: small checks and two paths -----------------

#: synthseg-labels-to-image: B=4 label maps of 256^3 at 1 mm, 32 labels
#: (0-31) in blocks, the scale of a whole-brain parcellation
SYNTH_B, SYNTH_SHAPE, SYNTH_LABELS, SYNTH_SEED = 4, (256, 256, 256), 32, 0
#: ixi-preprocess-histstd: an IXI T1's shape and spacing, stored in "PLI"
#: (Reorient to RAS permutes i and j and flips all three), cropped to
#: IXI_CROP after Resample to 1 mm; landmarks from IXI_CORPUS volumes
IXI_B, IXI_SHAPE, IXI_SPACING, IXI_CODES = 4, (256, 256, 150), (0.9375, 0.9375, 1.2), "PLI"
IXI_CROP, IXI_CORPUS, IXI_SEED = (224, 224, 160), 8, 0
#: the single timed calls at full width
SWAP_B, SWAP_SHAPE, SWAP_PATCH, SWAP_ITERATIONS = 4, (256, 256, 256), 15, 100
#: the small checks: B=2 subjects at ZOO_SHAPE, card against the CPU path
ZOO_B, ZOO_SHAPE = 2, (24, 28, 32)
ZOO_ATOL = 1e-5


def synthseg_pipeline(tio, spatial=None):
    """A SynthSeg-style generator: geometry on the label map, tissue drawn
    per label, then the intensity and resolution artifacts."""
    return tio.Compose(
        [
            spatial or tio.Spatial(scales=(0.9, 1.1), degrees=10, max_displacement=7.5),
            tio.LabelsToImage(label_key="seg"),
            tio.BiasField(std=0.5),
            tio.Gamma(log_gamma=(-0.3, 0.3)),
            tio.Anisotropy(downsampling=(1.5, 5)),
            tio.Noise(std=0.05),
            tio.RescaleIntensity(out_min=0.0, out_max=1.0),
        ]
    )


def ixi_pipeline(tio, landmarks, crop, target=1.0):
    """TorchIO's classic preprocessing with histogram standardization."""
    return tio.Compose(
        [
            tio.Reorient("RAS"),
            tio.Resample(target=target),
            tio.CropOrPad(crop),
            tio.HistogramStandardization(landmarks, include=["t1"]),
            tio.ZNormalization(include=["t1"]),
            tio.OneHot(),
        ]
    )


def synthseg_labels(torch, shape, device):
    """(1, *shape) int32 labels 0-31 in blocks: ``(i // 64) * 8 + (j //
    64) * 2 + k // 128`` at 256^3, the same blocks scaled to ``shape``."""
    i, j, k = (torch.arange(n, device=device) for n in shape)
    labels = (
        (i * 4 // shape[0])[:, None, None] * 8
        + (j * 4 // shape[1])[None, :, None] * 2
        + (k * 2 // shape[2])[None, None, :]
    )
    return labels.to(torch.int32)[None]


def make_synth_batch(tio, torch, b, shape, device):
    seg = synthseg_labels(torch, shape, device)
    subjects = [tio.Subject(seg=tio.LabelMap(seg.clone())) for _ in range(b)]
    return tio.SubjectsBatch.from_subjects(subjects)


def stored_affine(np, spacing, codes):
    """A 4x4 affine whose voxel axes run along ``codes`` (one letter a
    world axis, its sign), with ``spacing`` mm and an off-centre origin."""
    world = {"R": (0, 1), "L": (0, -1), "A": (1, 1), "P": (1, -1), "S": (2, 1), "I": (2, -1)}
    matrix = np.eye(4)
    matrix[:3, :3] = 0.0
    for voxel, code in enumerate(codes):
        axis, sign = world[code]
        matrix[axis, voxel] = sign * spacing[voxel]
    matrix[:3, 3] = (90.0, 110.0, 70.0)
    return matrix


def ixi_volumes(torch, b, shape, device, seed):
    """(B, 1, *shape) float32 intensities skewed toward the dark end, as
    an MR histogram is (the square of a uniform draw)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((b, 1, *shape), generator=gen, device=device) ** 2


def make_ixi_batch(tio, torch, np, b, shape, device, seed):
    """B subjects of a ``t1`` and an int32 ``seg`` (labels {0, 1, 2, 4} in
    blocks), stored in IXI_CODES at IXI_SPACING."""
    affine = stored_affine(np, IXI_SPACING, IXI_CODES)
    t1 = ixi_volumes(torch, b, shape, device, seed)
    seg = brats_labels(torch, shape, device)
    subjects = [
        tio.Subject(
            t1=tio.ScalarImage(t1[i], affine=affine), seg=tio.LabelMap(seg.clone(), affine=affine)
        )
        for i in range(b)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def ixi_landmarks(tio, torch, shape, device, seed):
    """``compute_histogram_landmarks`` over IXI_CORPUS volumes made from
    ``seed`` (set-up: not timed)."""
    corpus = ixi_volumes(torch, IXI_CORPUS, shape, device, seed + 1000)
    return tio.compute_histogram_landmarks(list(corpus))


def islands_seg(torch, seg):
    """``seg`` (B, 1, I, J, K) with a stray 3^3 island of every label
    near the far corner, each in a shell of background, so that
    KeepLargestComponent removes it."""
    out = seg.clone()
    for n, label in enumerate(sorted(set(torch.unique(seg).tolist()) - {0})):
        i, j, k = (s - 6 - 5 * n for s in seg.shape[2:])
        out[:, :, i - 1 : i + 4, j - 1 : j + 4, k - 1 : k + 4] = 0  # a shell of background
        out[:, :, i : i + 3, j : j + 3, k : k + 3] = label
    return out


def small_zoo_batch(tio, torch, np):
    """The small checks' subjects (on the CPU): a 1-channel ``t1``, a
    3-channel ``feat`` and an int32 ``seg`` (labels {0, 1, 2, 4} in blocks
    with a stray island each), stored in IXI_CODES at IXI_SPACING."""
    affine = stored_affine(np, IXI_SPACING, IXI_CODES)
    gen = torch.Generator().manual_seed(7)
    t1 = torch.rand((ZOO_B, 1, *ZOO_SHAPE), generator=gen)
    feat = torch.rand((ZOO_B, 3, *ZOO_SHAPE), generator=gen)
    feat[:, 1] += 0.5 * feat[:, 0]
    seg = islands_seg(torch, brats_labels(torch, ZOO_SHAPE, "cpu").expand(ZOO_B, 1, *ZOO_SHAPE))
    subjects = [
        tio.Subject(
            t1=tio.ScalarImage(t1[i], affine=affine),
            feat=tio.ScalarImage(feat[i], affine=affine),
            seg=tio.LabelMap(seg[i], affine=affine),
        )
        for i in range(ZOO_B)
    ]
    return tio.SubjectsBatch.from_subjects(subjects)


def zoo_cases(tio, torch, np):
    """(name, transform maker taking the device, seed, exact) of each
    module of the zoo's rest; ``exact``: the card must give the CPU's
    data bit for bit (index and label transforms), else within ZOO_ATOL."""
    gen = torch.Generator().manual_seed(3)
    corpus = [torch.rand((1, *ZOO_SHAPE), generator=gen) ** 2 for _ in range(3)]
    landmarks = tio.compute_histogram_landmarks(corpus)
    reference = torch.rand((1, 20, 18, 16), generator=gen)
    ref_affine = stored_affine(np, (1.1, 1.3, 0.9), "RAS")
    return [
        ("Transpose", lambda dev: tio.Transpose(), 0, True),
        ("CopyAffine", lambda dev: tio.CopyAffine("t1"), 0, True),
        ("Reorient", lambda dev: tio.Reorient("RAS"), 0, True),
        (
            "ToReferenceSpace",
            lambda dev: tio.ToReferenceSpace(tio.ScalarImage(reference.to(dev), affine=ref_affine)),
            0, True,
        ),
        ("Resize nearest", lambda dev: tio.Resize((20, 31, 17), image_interpolation="nearest"), 0, True),
        ("Resize linear", lambda dev: tio.Resize((20, 31, 17)), 0, False),
        # seed 0 gates the first element out (per instance, p=0.5)
        ("Anisotropy nearest", lambda dev: tio.Anisotropy(downsampling=(2, 4), image_interpolation="nearest", p=0.5), 0, True),
        ("Anisotropy linear", lambda dev: tio.Anisotropy(downsampling=(2, 4), p=0.5), 0, False),
        ("Swap", lambda dev: tio.Swap(patch_size=(5, 4, 6), num_iterations=(6, 12), p=0.5), 0, True),
        ("RemapLabels", lambda dev: tio.RemapLabels({1: 7, 4: 1}), 0, True),
        ("RemoveLabels", lambda dev: tio.RemoveLabels([2]), 0, True),
        ("SequentialLabels", lambda dev: tio.SequentialLabels(), 0, True),
        ("OneHot", lambda dev: tio.OneHot(num_classes=4), 0, True),
        ("Contour", lambda dev: tio.Contour(), 0, True),
        ("KeepLargestComponent", lambda dev: tio.KeepLargestComponent(), 0, True),
        ("PCA", lambda dev: tio.PCA(num_components=2, include=["feat"]), 0, False),
        ("HistogramStandardization", lambda dev: tio.HistogramStandardization(landmarks, include=["t1"]), 0, False),
        ("LabelsToImage", lambda dev: tio.LabelsToImage(label_key="seg", ignore_background=True), 0, False),
        ("Lambda", lambda dev: tio.Lambda(lambda x: x * 2 + 1, types_to_apply=[tio.ScalarImage]), 0, True),
        ("To", lambda dev: tio.To(torch.float16), 0, True),
    ]


def zoo_on_both(tio, make_batch, make_transform, seed):
    """``make_transform(device)`` on a batch from ``make_batch`` on the CPU
    and on the card from one seed: ((cpu, card) outputs, (cpu, card) next
    host draws, the card run's launches)."""
    import torch
    from torchio_tpu_torch.ops import kernel_lib as kl

    outs, draws, launched = [], [], {}
    for device in ("cpu", DEVICE):
        batch = make_batch().to(device)
        tio.seed(seed)
        transform = make_transform(torch.device(device))
        before = dict(kl.LAUNCHES)
        outs.append(transform(batch))
        draws.append(float(tio.random.random()))
        launched = {k: kl.LAUNCHES.get(k, 0) - before.get(k, 0) for k in KERNELS}
    return outs, draws, launched


def zoo_difference(np, name, cpu, gpu, exact):
    """The largest difference between the card's and the CPU's images;
    fails on another set of images, dtype, shape, affine or device."""
    if list(cpu.images) != list(gpu.images):
        fail(f"small {name}: images {list(gpu.images)} on the card, {list(cpu.images)} on the CPU")
    err = 0.0
    for key in cpu.images:
        want, got = cpu.images[key], gpu.images[key]
        if got.data.device.type != DEVICE or got.data.dtype != want.data.dtype:
            fail(f"small {name}: {key} {got.data.dtype} on {got.data.device}, {want.data.dtype}")
        if got.data.shape != want.data.shape or got.image_class is not want.image_class:
            fail(f"small {name}: {key} {tuple(got.data.shape)} against {tuple(want.data.shape)}")
        for a, b in zip(want.affines, got.affines):
            if not np.array_equal(a.data, b.data):
                fail(f"small {name}: {key} affines differ")
        diff = (got.data.cpu().double() - want.data.double()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    if err > (0.0 if exact else ZOO_ATOL):
        fail(f"small {name}: card against CPU max abs {err} (limit {0.0 if exact else ZOO_ATOL})")
    return err


def phase_small_zoo(torch, np, tio):
    """Each module of the zoo's rest on B=2 subjects at ZOO_SHAPE: card
    against the CPU path, from one seed. Index and label transforms equal,
    the rest within ZOO_ATOL; histories (Swap's locations included) and
    the next host draw equal; LabelsToImage launches the threefry kernel
    once for each label it draws, the others launch no kernel."""
    torch.exp(torch.zeros(1 << 20))  # warm the CPU thread pool (see both_devices)
    lines = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Swap warns of the label map
        for name, make, seed, exact in zoo_cases(tio, torch, np):
            (cpu, gpu), draws, launched = zoo_on_both(
                tio, lambda: small_zoo_batch(tio, torch, np), make, seed
            )
            history = [(h.name, h.params) for h in gpu.applied_transforms]
            if not json_close(history, [(h.name, h.params) for h in cpu.applied_transforms]):
                fail(f"small {name}: the card's history {history} differs from the CPU's")
            if draws[0] != draws[1]:
                fail(f"small {name}: next host draws {draws}")
            err = zoo_difference(np, name, cpu, gpu, exact)
            want = {k: 0 for k in KERNELS}
            if name == "LabelsToImage":
                means = history[0][1]["means"]
                want["threefry_normal"] = sum(
                    any(m[label] for m in means) for label in sorted(means[0])
                )
            if launched != want:
                fail(f"small {name}: launches {launched}, expected {want}")
            keep = history[0][1].get("_keep") if history else None
            if name.startswith(("Anisotropy", "Swap")) and keep != [False, True]:
                fail(f"small {name}: gated elements {keep}, expected the first gated out")
            lines.append(f"{name} {'equal' if exact else f'{err:.3g}'}")
    print(
        f"small zoo ({ZOO_B} x (1 + 3 + 1) x {'x'.join(map(str, ZOO_SHAPE))}) cuda vs cpu:"
        f" {'; '.join(lines)} (limit {ZOO_ATOL} where not equal); histories, the next host"
        " draw and the launches equal"
    )


#: integer images on the card: torch's support for uint16 and uint32 is
#: partial, so each dtype goes through the modules that cast or move it
INTEGER_DTYPES = ("int16", "uint16", "uint32")


def integer_cases(tio):
    """(name, transform maker, exact) of the modules that move or cast an
    integer image: the index and label ones must equal the CPU path, the
    float32 ones (then a saturating cast) within 1 + ZOO_ATOL of the
    image's largest magnitude."""
    return [
        ("Flip", lambda: tio.Flip(axes=(0, 2)), True),
        ("Reorient", lambda: tio.Reorient("RAS"), True),
        ("Swap", lambda: tio.Swap(patch_size=4, num_iterations=5), True),
        ("RemapLabels", lambda: tio.RemapLabels({1: 7, 4: 1}), True),
        ("Resize", lambda: tio.Resize((20, 31, 17)), False),
        ("Anisotropy", lambda: tio.Anisotropy(downsampling=(2, 4)), False),
        ("Blur", lambda: tio.Blur(std=(0.5, 1.5)), False),
        ("Motion", lambda: tio.Motion(degrees=10, translation=5, num_transforms=2), False),
        ("Ghosting", lambda: tio.Ghosting(intensity=(0.5, 1)), False),
        ("Spike", lambda: tio.Spike(intensity=(1, 3)), False),
    ]


def integer_batch(tio, torch, np, dtype):
    """small_zoo_batch's ``t1`` at 10 % to 97 % of ``dtype``'s range (the
    k-space artifacts ring past both ends) and its ``seg``, both in
    ``dtype``."""
    batch = small_zoo_batch(tio, torch, np)
    info = np.iinfo(dtype)
    top = float(info.max) * 0.97
    t1 = batch.t1.data.double() * top * 0.87 + top * 0.1
    batch.t1.data = t1.to(torch.int64).to(getattr(torch, dtype))
    batch.seg.data = batch.seg.data.to(getattr(torch, dtype))
    return batch


def phase_small_integers(torch, np, tio):
    """int16, uint16 and uint32 images through the modules that move or
    cast them, on the card against the CPU path: the same dtype, the
    index and label transforms equal, the float32 ones within 1 +
    ZOO_ATOL of the largest magnitude (cuFFT and the CPU's FFT round
    differently; both convert back saturating, as XLA does)."""
    worst = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Swap warns of the label map
        for dtype in INTEGER_DTYPES:
            for name, make, exact in integer_cases(tio):
                (cpu, gpu), draws, _ = zoo_on_both(
                    tio, lambda: integer_batch(tio, torch, np, dtype), lambda dev: make(), 2
                )
                if draws[0] != draws[1]:
                    fail(f"small {name} on {dtype}: next host draws {draws}")
                for key in ("t1", "seg"):
                    want, got = cpu.images[key].data, gpu.images[key].data
                    if got.dtype != want.dtype or got.dtype != getattr(torch, dtype):
                        fail(f"small {name} on {dtype}: {key} {got.dtype}, the CPU's {want.dtype}")
                    diff = float((got.cpu().double() - want.double()).abs().max())
                    limit = 0.0 if exact else 1 + ZOO_ATOL * float(want.double().abs().max())
                    if diff > limit:
                        fail(f"small {name} on {dtype}: {key} differs by {diff} (limit {limit})")
                    worst[name] = max(worst.get(name, 0.0), diff)
    print(
        f"small integer images ({', '.join(INTEGER_DTYPES)}; {ZOO_B} x 24x28x32) cuda vs cpu:"
        f" largest difference {worst} (index and label transforms equal, the rest within 1 +"
        f" {ZOO_ATOL} of the largest magnitude); dtypes kept"
    )


def phase_small_zoo_paths(torch, np, tio, rs):
    """synthseg-labels-to-image (its Spatial a whole-voxel translation, so
    that the nearest label resample has no ties) and ixi-preprocess-histstd
    on small batches: card against the CPU path; ixi's labels equal off
    near ties of its Resample."""
    shape = (32, 36, 28)
    spatial = lambda: tio.Spatial(translation=(1, -2, 1))  # noqa: E731
    (cpu, gpu), _, launched = both_devices(
        tio, lambda: make_synth_batch(tio, torch, 2, shape, "cpu"),
        lambda: synthseg_pipeline(tio, spatial()), 5,
    )
    if not json_close(element_histories(gpu), element_histories(cpu)):
        fail("small synthseg: the card's history differs from the CPU's")
    err = float((gpu.image_from_labels.data.cpu() - cpu.image_from_labels.data).abs().max())
    labels = len(cpu.applied_transforms[1].params["means"][0])
    seg_equal = torch.equal(gpu.seg.data.cpu(), cpu.seg.data)
    if launched["resample"] != 1 or launched["threefry_normal"] != labels + 2:
        fail(f"small synthseg: launches {launched}, {labels} labels")
    print(
        f"small synthseg-labels-to-image (2 x 32x36x28, {labels} labels) cuda vs cpu:"
        f" image max abs {err:.3g} (limit {SLICE_ATOL}); seg equal {seg_equal}; launches"
        f" resample {launched['resample']}, threefry {launched['threefry_normal']}"
    )
    if not err <= SLICE_ATOL or not seg_equal:
        fail("the small synthseg path differs from the CPU path")

    shape, crop = (40, 44, 24), (32, 32, 24)
    gen = torch.Generator().manual_seed(4)
    landmarks = tio.compute_histogram_landmarks(
        [torch.rand((1, *shape), generator=gen) ** 2 for _ in range(3)]
    )
    (cpu, gpu), _, launched = both_devices(
        tio, lambda: make_ixi_batch(tio, torch, np, 2, shape, "cpu", 6),
        lambda: ixi_pipeline(tio, landmarks, crop), 6,
    )
    if not json_close(element_histories(gpu), element_histories(cpu)):
        fail("small ixi: the card's history differs from the CPU's")
    records = {h.name: h.params for h in cpu.applied_transforms}
    err = float((gpu.t1.data.cpu() - cpu.t1.data).abs().max())
    original = records["Resample"]["original"]
    affine = tio.AffineMatrix(np.asarray(original["affine"]))
    maps, fields, out_shape = target_grids(rs, records["Resample"], affine, 2, "cpu")
    ties = nearest_ties(torch, rs, maps, fields, out_shape)
    i0, i1, j0, j1, k0, k1 = records["Crop"]["cropping"]
    n = ties.shape[2:]
    ties = ties[:, :, i0 : n[0] - i1, j0 : n[1] - j1, k0 : n[2] - k1]
    differ = (gpu.seg.data.cpu() != cpu.seg.data).any(dim=1, keepdim=True)
    off = int((differ & ~ties).sum())
    if launched["resample"] != 2 or launched["threefry_normal"]:
        fail(f"small ixi: launches {launched}")
    print(
        f"small ixi-preprocess-histstd (2 x (1 + 1) x 40x44x24 in {IXI_CODES} at"
        f" {IXI_SPACING} mm -> RAS, 1 mm, {'x'.join(map(str, crop))}) cuda vs cpu: t1 max abs"
        f" {err:.3g} (limit {SLICE_ATOL}); one-hot voxels differing {int(differ.sum())}, off"
        f" near ties {off}; resample launches {launched['resample']}"
    )
    if not err <= SLICE_ATOL or off:
        fail("the small ixi path differs from the CPU path")


def synth_launches(call_history):
    """The threefry launches a synthseg call implies: one for each label
    LabelsToImage draws (means or stds not all zero), one for BiasField's
    fields and one for Noise."""
    records = {h.name: h.params for h in call_history}
    means, stds = records["LabelsToImage"]["means"], records["LabelsToImage"]["stds"]
    drawn = sum(
        any(m[label] for m in means) or any(s[label] for s in stds) for label in sorted(means[0])
    )
    return drawn + 2


class KeptHistory:
    """A pipeline that keeps each call's history records."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.histories = []

    def __call__(self, batch):
        out = self.pipeline(batch)
        self.histories.append(list(out.applied_transforms))
        return out


def phase_synthseg(torch, tio, kl, smi, profile: str | None):
    """synthseg-labels-to-image: the generator on B=4 label maps of 256^3
    (32 labels, made on the card)."""
    name = "synthseg-labels-to-image"
    batch = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, torch.device(DEVICE))
    call = KeptHistory(synthseg_pipeline(tio))
    tio.seed(SYNTH_SEED)
    out, times, per_call, totals, peak, histories = drive(
        torch, kl, call, batch, ("resample", "threefry_normal")
    )
    for launched, history in zip(per_call, call.histories):
        want = {"resample": 1, "threefry_normal": synth_launches(history)}
        others = {k: n for k, n in launched.items() if k not in want and n}
        if any(launched[k] != n for k, n in want.items()) or others:
            fail(f"{name}: launches {launched}, expected {want}")
    image = out.image_from_labels.data
    if tuple(image.shape) != (SYNTH_B, 1, *SYNTH_SHAPE) or image.device.type != DEVICE:
        fail(f"{name} image {tuple(image.shape)} on {image.device}")
    low, high = float(image.min()), float(image.max())
    if not bool(torch.isfinite(image).all()) or low < 0.0 or high > 1.0:
        fail(f"{name}: image in [{low}, {high}]")
    labels = set(torch.unique(out.seg.data).tolist())
    if out.seg.data.dtype != torch.int32 or not labels <= set(range(SYNTH_LABELS)):
        fail(f"{name}: seg {out.seg.data.dtype} labels {sorted(labels)}")
    drawn = [synth_launches(h) - 2 for h in call.histories]
    report_path(name, times, peak, per_call, ("resample", "threefry_normal"), smi, "subjects", SYNTH_B)
    print(f"{name}: labels drawn by LabelsToImage per call {drawn}; histories {histories[-1]}")
    if profile:
        profile_same_draws(torch, tio, SYNTH_SEED, call, batch, profile, name)
    return totals


def phase_ixi(torch, np, tio, kl, smi, profile: str | None):
    """ixi-preprocess-histstd: TorchIO's classic preprocessing on B=4 IXI
    T1-shaped subjects stored in IXI_CODES, with landmarks from
    ``compute_histogram_landmarks`` (set-up, untimed)."""
    name = "ixi-preprocess-histstd"
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    landmarks = ixi_landmarks(tio, torch, IXI_SHAPE, dev, IXI_SEED)
    setup_s = time.perf_counter() - t0
    batch = make_ixi_batch(tio, torch, np, IXI_B, IXI_SHAPE, dev, IXI_SEED)
    pipeline = ixi_pipeline(tio, landmarks, IXI_CROP)
    tio.seed(IXI_SEED)
    out, times, per_call, totals, peak, histories = drive(torch, kl, pipeline, batch, ("resample",))
    for launched in per_call:
        if launched["resample"] != 2 or any(n for k, n in launched.items() if k != "resample"):
            fail(f"{name}: launches {launched}, expected 2 resample launches a call")
    t1, seg = out.t1.data, out.seg.data
    if tuple(t1.shape) != (IXI_B, 1, *IXI_CROP) or t1.device.type != DEVICE:
        fail(f"{name} t1 {tuple(t1.shape)} on {t1.device}")
    if tuple(seg.shape) != (IXI_B, 5, *IXI_CROP) or seg.dtype != torch.float32:
        fail(f"{name} seg {tuple(seg.shape)} {seg.dtype}")
    if not bool(torch.isfinite(t1).all()) or not torch.equal(seg.sum(dim=1), torch.ones_like(seg[:, 0])):
        fail(f"{name}: non-finite t1 or a one-hot voxel that does not sum to 1")
    means = t1.mean(dim=(1, 2, 3, 4))
    stds = t1.std(dim=(1, 2, 3, 4))
    if float((means.abs()).max()) > 1e-3 or float((stds - 1).abs().max()) > 1e-3:
        fail(f"{name}: z-normalised t1 means {means.tolist()}, stds {stds.tolist()}")
    orientation = "".join(out.t1.affines[0].orientation)
    spacing = out.t1.affines[0].spacing
    if orientation != "RAS" or not np.allclose(spacing, 1.0):
        fail(f"{name}: output {orientation} at {spacing} mm")
    report_path(name, times, peak, per_call, ("resample",), smi, "subjects", IXI_B)
    print(
        f"{name}: landmarks {[round(float(x), 3) for x in landmarks]} from {IXI_CORPUS} volumes in"
        f" {setup_s:.2f} s (set-up); histories {histories[-1]}"
    )
    if profile:
        profile_same_draws(torch, tio, IXI_SEED, pipeline, batch, profile, name)
    return totals


# --- host I/O: subjects stored as files -----------------------------------------

#: the IXI T1s ship as int16 NIfTI: the seeded volumes in [0, 1) times
#: IXI_INT16_SCALE, rounded
IXI_INT16_SCALE = 1000.0
#: the 1 mm RAS reference grid of ixi-nifti-preprocess: the field of view
#: of IXI_SHAPE at IXI_SPACING (240 x 240 x 180 mm)
IXI_REFERENCE_SHAPE = (240, 240, 180)
#: every dtype ``write_nifti`` writes as itself, for the small I/O phase
IO_DTYPES = ("uint8", "int8", "int16", "uint16", "int32", "uint32", "int64", "uint64", "float32", "float64")
IO_SHAPE = (20, 24, 18)
#: ixi-nifti-preprocess's calls: each reads its 4 subjects (about 2 s on
#: the card's host), so fewer than the other paths'
IXI_FILE_WARMUP, IXI_FILE_TIMED = 1, 2


def ixi_int16(torch, b, shape, device, seed):
    """The seeded IXI volumes quantised to int16, as IXI ships its T1s."""
    return torch.round(ixi_volumes(torch, b, shape, device, seed) * IXI_INT16_SCALE).to(torch.int16)


def ixi_reference_affine(np):
    """1 mm RAS, its first voxel at the lowest corner of the IXI subjects'
    voxel centres (stored_affine's grid)."""
    stored = stored_affine(np, IXI_SPACING, IXI_CODES)
    corners = np.array(list(itertools.product(*[(0, n - 1) for n in IXI_SHAPE])), np.float64)
    world = corners @ stored[:3, :3].T + stored[:3, 3]
    affine = np.eye(4)
    affine[:3, 3] = world.min(axis=0)
    return affine


def check_native(native, name):
    """No fallback: the decode ran the native library (gunzip for a
    ``.nii.gz``, the layout transform for every 3D read)."""
    if not native.available():
        fail(f"{name}: the native decode library did not load: {native.build_error()}")
    if native.CALLS["f2c_transpose"] < 1:
        fail(f"{name}: no read went through the native layout transform: {native.CALLS}")


def decode_times(np, tio, native, path, reps=2):
    """A subject file's decode on the host, native (gunzip + layout
    transform) and plain (zlib through gzip + numpy's copy), in turns:
    the medians in seconds."""
    raw = Path(path).read_bytes()
    header = tio.io.read_header(path)
    expected = header.vox_offset + int(np.prod(header.shape)) * header.dtype.itemsize
    count = int(np.prod(header.shape))

    def decode(gunzip, transpose):
        data = gunzip(raw, expected)
        disk = np.frombuffer(data, header.dtype, count, header.vox_offset).reshape(header.shape, order="F")
        return transpose(disk)

    times = {"native": [], "plain": []}
    results = {}
    for _ in range(reps):
        for kind, gunzip, transpose in (
            ("native", native.gunzip, native.f2c_transpose),
            ("plain", native.gunzip_plain, native.f2c_transpose_plain),
        ):
            t0 = time.perf_counter()
            results[kind] = decode(gunzip, transpose)
            times[kind].append(time.perf_counter() - t0)
    if not np.array_equal(results["native"], results["plain"]):
        fail(f"native decode of {path} differs from the plain one")
    return {kind: statistics.median(t) for kind, t in times.items()}


def phase_small_io(torch, np, tio, native):
    """Files of every dtype ``write_nifti`` writes, written on the host and
    loaded on the card, equal to the CPU's load; a lazy CropOrPad of
    subjects read from files on the card equal to the eager one of the
    same subjects loaded first."""
    from torchio_tpu_torch import config

    rng = np.random.default_rng(0)
    native.reset_calls()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as tmp:
        for dtype in IO_DTYPES:
            if dtype.startswith("float"):
                data = (rng.standard_normal((2, *IO_SHAPE)) * 1e6).astype(dtype)
            else:
                info = np.iinfo(dtype)
                data = rng.integers(info.min, info.max, (2, *IO_SHAPE), dtype=dtype, endpoint=True)
            for suffix in (".nii", ".nii.gz"):
                path = Path(tmp) / f"{dtype}{suffix}"
                tio.io.write_nifti(path, data, stored_affine(np, IXI_SPACING, "LPS"))
                card = tio.ScalarImage(path)
                card.load()
                previous = config.set_default_device("cpu")
                try:
                    host = tio.ScalarImage(path).numpy()
                finally:
                    config.set_default_device(previous)
                if card.data.device.type != DEVICE or str(card.dtype) != f"torch.{dtype}":
                    fail(f"small io: {path.name} loaded as {card.dtype} on {card.data.device}")
                if not (np.array_equal(card.numpy(), host) and np.array_equal(host, data)):
                    fail(f"small io: {path.name} on the card differs from the CPU's load")
        paths = []
        seg = np.zeros((1, *IO_SHAPE), np.int32)
        seg[0, 5:15, 6:18, 4:14] = 2
        for i in range(2):
            t1 = Path(tmp) / f"s{i}_t1.nii.gz"
            label = Path(tmp) / f"s{i}_seg.nii"
            tio.io.write_nifti(t1, rng.random((1, *IO_SHAPE)).astype(np.float32) * 800, np.eye(4))
            tio.io.write_nifti(label, seg, np.eye(4))
            paths.append((t1, label))
        for target, mode in (((16, 30, 12), "constant"), ((24, 20, 22), "constant"), ((16, 30, 12), "reflect")):
            outs = []
            for loaded in (False, True):
                for i, (t1, label) in enumerate(paths):
                    subject = tio.Subject(t1=tio.ScalarImage(t1), seg=tio.LabelMap(label))
                    if loaded:
                        subject.load()
                    tio.seed(i)
                    out = tio.CropOrPad(target, padding_mode=mode, fill=3)(subject)
                    outs.append(out)
            half = len(outs) // 2
            for lazy, eager in zip(outs[:half], outs[half:], strict=True):
                for key in ("t1", "seg"):
                    if lazy[key].is_loaded and mode == "constant":
                        fail("small io: a lazy CropOrPad read its input before the data was used")
                    got, want = lazy[key].data, eager[key].data
                    if got.device.type != DEVICE or not torch.equal(got, want):
                        fail(f"small io: lazy CropOrPad {target} {mode} differs from the eager one ({key})")
                    if not np.array_equal(lazy[key].affine.data, eager[key].affine.data):
                        fail(f"small io: lazy CropOrPad {target} {mode} moved the affine differently")
    check_native(native, "small io")
    print(
        f"small io: {len(IO_DTYPES)} dtypes x (.nii, .nii.gz) of 2 x {IO_SHAPE} loaded on the card equal"
        f" to the CPU's load and the data written; lazy CropOrPad (crop, pad, reflect) of 2 subjects"
        f" read from files equal to the eager one on the card; native calls {native.CALLS}"
    )


def write_ixi_files(torch, np, tio, directory):
    """IXI_B subjects as ``.nii.gz`` (an int16 t1, an int32 seg, in
    IXI_CODES at IXI_SPACING) and the 1 mm RAS reference, written with the
    port's ``write_nifti``; returns the int16 t1s on the card, the seg, the
    subjects' paths and the reference's path."""
    dev = torch.device(DEVICE)
    affine = stored_affine(np, IXI_SPACING, IXI_CODES)
    t1 = ixi_int16(torch, IXI_B, IXI_SHAPE, dev, IXI_SEED)
    seg = brats_labels(torch, IXI_SHAPE, dev)
    paths = []
    for i in range(IXI_B):
        t1_path, seg_path = directory / f"ixi{i}_t1.nii.gz", directory / f"ixi{i}_seg.nii.gz"
        tio.io.write_nifti(t1_path, t1[i], affine)
        if i == 0:
            tio.io.write_nifti(seg_path, seg, affine)
        else:  # every subject has the same labels: a copy of the first file
            shutil.copyfile(paths[0][1], seg_path)
        paths.append((t1_path, seg_path))
    reference = directory / "reference_1mm_ras.nii.gz"
    tio.io.write_nifti(reference, np.zeros(IXI_REFERENCE_SHAPE, np.uint8), ixi_reference_affine(np))
    return t1, seg, paths, reference


def phase_ixi_nifti(torch, np, tio, kl, native, smi, profile: str | None):
    """ixi-nifti-preprocess: ixi-preprocess-histstd over subjects stored as
    ``.nii.gz`` (int16 t1, int32 seg), read lazily: Resample to a 1 mm RAS
    reference given as a file, the landmarks from
    ``compute_histogram_landmarks`` on the t1 paths. Every call builds its
    subjects from the paths and batches them (the read: decode on the
    host, copy to the card), then runs the pipeline; the output must equal
    the same pipeline on the same int16 volumes held in memory, bit for
    bit."""
    name = "ixi-nifti-preprocess"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ixi_") as tmp:
        t0 = time.perf_counter()
        t1, seg, paths, reference = write_ixi_files(torch, np, tio, Path(tmp))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        landmarks = tio.compute_histogram_landmarks([t1_path for t1_path, _ in paths])
        landmarks_s = time.perf_counter() - t0
        pipeline = ixi_pipeline(tio, landmarks, IXI_CROP, target=reference)

        def read_batch():
            subjects = [
                tio.Subject(t1=tio.ScalarImage(t1_path), seg=tio.LabelMap(seg_path))
                for t1_path, seg_path in paths
            ]
            if any(image.is_loaded for s in subjects for image in s.images.values()):
                fail(f"{name}: a subject was read before its batch was built")
            return tio.SubjectsBatch.from_subjects(subjects)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_calls()
        kl.reset_launches()
        read_times, call_times, per_call, out = [], [], [], None
        for _ in range(IXI_FILE_WARMUP + IXI_FILE_TIMED):
            before = dict(kl.LAUNCHES)
            t0 = time.perf_counter()
            batch = read_batch()
            torch.cuda.synchronize()
            t1_read = time.perf_counter()
            tio.seed(IXI_SEED)
            out = pipeline(batch)
            torch.cuda.synchronize()
            read_times.append(t1_read - t0)
            call_times.append(time.perf_counter() - t1_read)
            per_call.append({k: kl.LAUNCHES[k] - before[k] for k in KERNELS})
        totals = {k: kl.LAUNCHES[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        calls = dict(native.CALLS)
        check_native(native, name)
        if calls["gunzip"] != 2 * IXI_B * (IXI_FILE_WARMUP + IXI_FILE_TIMED):
            fail(f"{name}: {calls['gunzip']} native gunzips, expected one a file read")
        for launched in per_call:
            if launched["resample"] != 2 or any(n for k, n in launched.items() if k != "resample"):
                fail(f"{name}: launches {launched}, expected 2 resample launches a call")
        if out.t1.data.device.type != DEVICE or tuple(out.t1.data.shape) != (IXI_B, 1, *IXI_CROP):
            fail(f"{name}: t1 {tuple(out.t1.data.shape)} on {out.t1.data.device}")
        seg_out = out.seg.data
        if tuple(seg_out.shape) != (IXI_B, 5, *IXI_CROP):
            fail(f"{name}: seg {tuple(seg_out.shape)}")
        if not torch.equal(seg_out.sum(dim=1), torch.ones_like(seg_out[:, 0])):
            fail(f"{name}: a one-hot voxel does not sum to 1")
        orientation, spacing = "".join(out.t1.affines[0].orientation), out.t1.affines[0].spacing
        if orientation != "RAS" or not np.allclose(spacing, 1.0):
            fail(f"{name}: output {orientation} at {spacing} mm")
        # the same pipeline on the same int16 volumes in memory
        header_affine = tio.io.read_header(paths[0][0]).affine
        memory_landmarks = tio.compute_histogram_landmarks(list(t1))
        if not np.array_equal(memory_landmarks, landmarks):
            fail(f"{name}: landmarks from the files differ from the in-memory ones")
        reference_space = (IXI_REFERENCE_SHAPE, tio.io.read_header(reference).affine)
        memory_pipeline = ixi_pipeline(tio, memory_landmarks, IXI_CROP, target=reference_space)
        memory = tio.SubjectsBatch.from_subjects([
            tio.Subject(
                t1=tio.ScalarImage(t1[i], affine=header_affine),
                seg=tio.LabelMap(seg.clone(), affine=header_affine),
            )
            for i in range(IXI_B)
        ])
        tio.seed(IXI_SEED)
        want = memory_pipeline(memory)
        for key in ("t1", "seg"):
            if not torch.equal(out[key].data, want[key].data):
                diff = float((out[key].data.double() - want[key].data.double()).abs().max())
                fail(f"{name}: {key} from the files differs from the in-memory run by {diff}")
            for a, b in zip(out[key].affines, want[key].affines, strict=True):
                if not np.array_equal(a.data, b.data):
                    fail(f"{name}: {key} affine from the files differs from the in-memory run")
        decode = decode_times(np, tio, native, paths[0][0])
        seg_decode = decode_times(np, tio, native, paths[0][1])
        times = [r + c for r, c in zip(read_times, call_times)]
        report_path(name, times, peak, per_call, ("resample",), smi, "subjects", IXI_B, IXI_FILE_WARMUP)
        timed_reads, timed_calls = read_times[IXI_FILE_WARMUP:], call_times[IXI_FILE_WARMUP:]
        print(
            f"{name}: read (decode + copy to the card, {IXI_B} subjects of an int16 t1 and an int32"
            f" seg, .nii.gz) median {statistics.median(timed_reads) * 1e3:.1f} ms a call, pipeline"
            f" median {statistics.median(timed_calls) * 1e3:.1f} ms a call (reads"
            f" {[round(t * 1e3, 1) for t in read_times]} ms, pipelines"
            f" {[round(t * 1e3, 1) for t in call_times]} ms); decode of one subject's files on the"
            f" host: t1 native {decode['native'] * 1e3:.1f} ms, plain {decode['plain'] * 1e3:.1f} ms;"
            f" seg native {seg_decode['native'] * 1e3:.1f} ms, plain {seg_decode['plain'] * 1e3:.1f}"
            f" ms; native calls {calls}; output equal to the in-memory run bit for bit; files written in"
            f" {write_s:.2f} s, landmarks from {IXI_B} paths in {landmarks_s:.2f} s (set-up); card {smi}"
        )
        if profile:

            def call(_):
                return pipeline(read_batch())

            profile_same_draws(torch, tio, IXI_SEED, call, None, profile, f"{name} (read + pipeline)")
            profile_same_draws(torch, tio, IXI_SEED, pipeline, read_batch(), profile, f"{name} (pipeline)")
    return totals


# --- DICOM: a CT series stored as files ----------------------------------------

#: ct-dicom-preprocess: LIDC-IDRI's thoracic CT layout (512 x 512 slices of
#: 0.703125 mm pixels, 1.25 mm apart), CT_B series of CT_SHAPE int16
#: Hounsfield units, the image plane tilted CT_TILT degrees about x and y
CT_B, CT_SHAPE, CT_SPACING = 2, (512, 512, 240), (0.703125, 0.703125, 1.25)
CT_TILT, CT_SPACING_OUT, CT_CROP, CT_SEED = (3.0, 2.0), 1.5, (224, 224, 192), 15
#: each call reads its CT_B series (about 1 s a series on a host), so
#: fewer calls than the in-memory paths'
CT_WARMUP, CT_TIMED = 1, 2
#: the DICOM writer keeps 10 significant digits of every decimal string
#: (positions of a few hundred mm): the affine read back agrees with the
#: one written within this many mm
CT_AFFINE_ATOL = 1e-6
#: the compressed syntaxes' short series (the Python encoders take about a
#: second a 512 x 512 slice): the first slices of the first CT series
CT_CODEC_SLICES = 4
CT_CODECS = {"rle": None, "jpeg-lossless": "jpegll", "jpeg-ls": "jls"}
#: ct-dicom-preprocess's launches a call: Resample(1.5) and Spatial
#: resample the batch once each, Noise draws its field in one launch
CT_LAUNCHES = {"resample": 2, "threefry_normal": 1}


def ct_pipeline(tio):
    """A CT preprocessing and augmentation chain: canonical orientation,
    1.5 mm isotropic, the HU window of soft tissue and lung scaled to
    [-1, 1], a fixed field of view, then a random affine and elastic move
    and noise."""
    return tio.Compose(
        [
            tio.Reorient("RAS"),
            tio.Resample(target=CT_SPACING_OUT),
            tio.Clamp(out_min=-1000, out_max=1000),
            tio.RescaleIntensity(out_min=-1, out_max=1),
            tio.CropOrPad(CT_CROP),
            tio.Spatial(degrees=10, scales=0.1, max_displacement=7.5),
            tio.Noise(std=0.05),
        ]
    )


def ct_volumes(np, b, shape, seed):
    """(B, 1, *shape) int16 Hounsfield units made on the host from
    ``seed``: air (-1024) around an elliptic body of soft tissue (40 HU)
    whose section changes slowly along k, two lungs (-850 HU) and a spine
    whose bone peaks near 3000 HU, with 20 HU of noise."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, shape[0], dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, shape[1], dtype=np.float32)[None, :, None]
    z = np.linspace(0, 1, shape[2], dtype=np.float32)[None, None, :]
    out = np.empty((b, 1, *shape), np.int16)
    for n in range(b):
        half = 0.8 + 0.05 * np.sin(2 * np.pi * (z + 0.3 * n))
        body = (x / half) ** 2 + (y / (0.65 * half)) ** 2 < 1
        lungs = ((np.abs(x) - 0.33) / (0.26 * half)) ** 2 + ((y + 0.05) / (0.38 * half)) ** 2 < 1
        spine = x**2 + (y - 0.38) ** 2
        hu = np.where(body, np.float32(40), np.float32(-1024))
        hu = np.where(body & lungs, np.float32(-850), hu)
        hu = np.where(spine < 0.006, np.float32(3000) - spine * np.float32(4e5), hu)
        hu = hu + rng.standard_normal(hu.shape, dtype=np.float32) * np.float32(20)
        out[n, 0] = np.clip(np.round(hu), -1024, 3071).astype(np.int16)
    return out


def ct_affine(np):
    """The series' RAS affine: voxel axes L, P, S (DICOM's image plane, in
    LPS), CT_SPACING, tilted CT_TILT degrees about x and then y, the first
    voxel at (179.6, 179.6, -320) mm."""
    ax, ay = np.radians(CT_TILT)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    affine = np.eye(4)
    affine[:3, :3] = rx @ ry @ np.diag([-CT_SPACING[0], -CT_SPACING[1], CT_SPACING[2]])
    affine[:3, 3] = (179.6484375, 179.6484375, -320.0)
    return affine


def write_ct_series(np, volumes, affine, directory, seed):
    """Each volume as a one-file-a-slice series (explicit VR little
    endian) by the port's writer, its files then renamed in a seeded
    order, as an archive's UID-named files are: the reader must sort the
    slices along their normal."""
    dicom = importlib.import_module("torchio_tpu_torch.io.dicom")
    rng = np.random.default_rng(seed)
    series = []
    for n, volume in enumerate(volumes):
        path = directory / f"ct{n}"
        dicom.write_dicom_series(path, volume, affine)
        files = sorted(path.iterdir())
        for file, rank in zip(files, rng.permutation(len(files)), strict=True):
            file.rename(path / f"1.2.826.0.{rank:06d}.dcm")
        series.append(path)
    return series


def phase_ct_dicom(torch, np, tio, kl, native, smi, profile: str | None):
    """ct-dicom-preprocess: CT_B thoracic CT series stored as DICOM files
    (CT_SHAPE int16, explicit VR little endian, file names out of slice
    order), read lazily each call: ``Subject(ct=ScalarImage(series_dir))``
    for each, ``SubjectsBatch.from_subjects`` (the read: parse and sort on
    the host, copy to the card), then ``ct_pipeline``. The volume read
    must equal the one written, bit for bit, its affine the one written
    within CT_AFFINE_ATOL mm, and the output the same pipeline's on the
    same int16 volumes held in memory with the header's affine, bit for
    bit."""
    name = "ct-dicom-preprocess"
    dicom = importlib.import_module("torchio_tpu_torch.io.dicom")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ct_") as tmp:
        t0 = time.perf_counter()
        volumes = ct_volumes(np, CT_B, CT_SHAPE, CT_SEED)
        written = ct_affine(np)
        series = write_ct_series(np, volumes, written, Path(tmp), CT_SEED)
        setup_s = time.perf_counter() - t0
        pipeline = ct_pipeline(tio)

        def read_batch():
            subjects = [tio.Subject(ct=tio.ScalarImage(path)) for path in series]
            if any(s.ct.is_loaded for s in subjects):
                fail(f"{name}: a series was read before its batch was built")
            return tio.SubjectsBatch.from_subjects(subjects)

        # the read against what was written
        first = read_batch()
        stored = torch.from_numpy(volumes).to(DEVICE)
        if first.ct.data.device.type != DEVICE or not torch.equal(first.ct.data, stored):
            fail(f"{name}: the series read differ from the int16 volumes written")
        header = [a.data.copy() for a in first.ct.affines]
        affine_err = max(float(np.abs(a - written).max()) for a in header)
        if not affine_err <= CT_AFFINE_ATOL:
            fail(f"{name}: the affine read is {affine_err} mm from the one written")
        del first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kl.reset_launches()
        read_times, call_times, per_call, out = [], [], [], None
        for _ in range(CT_WARMUP + CT_TIMED):
            before = dict(kl.LAUNCHES)
            t0 = time.perf_counter()
            batch = read_batch()
            torch.cuda.synchronize()
            t_read = time.perf_counter()
            tio.seed(CT_SEED)
            out = pipeline(batch)
            torch.cuda.synchronize()
            read_times.append(t_read - t0)
            call_times.append(time.perf_counter() - t_read)
            per_call.append({k: kl.LAUNCHES[k] - before[k] for k in KERNELS})
        totals = {k: kl.LAUNCHES[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        expected = {k: CT_LAUNCHES.get(k, 0) for k in KERNELS}
        for launched in per_call:
            if launched != expected:
                fail(f"{name}: launches {launched}, expected {expected} a call")
        data = out.ct.data
        if data.device.type != DEVICE or tuple(data.shape) != (CT_B, 1, *CT_CROP):
            fail(f"{name}: output {tuple(data.shape)} on {data.device}")
        if not bool(torch.isfinite(data).all()):
            fail(f"{name}: non-finite output")
        orientation, spacing = "".join(out.ct.affines[0].orientation), out.ct.affines[0].spacing
        if orientation != "RAS" or not np.allclose(spacing, CT_SPACING_OUT):
            fail(f"{name}: output {orientation} at {spacing} mm")
        # the same pipeline on the same int16 volumes in memory
        memory = tio.SubjectsBatch.from_subjects(
            [tio.Subject(ct=tio.ScalarImage(stored[n], affine=header[n])) for n in range(CT_B)]
        )
        tio.seed(CT_SEED)
        want = pipeline(memory)
        if not torch.equal(data, want.ct.data):
            diff = float((data.double() - want.ct.data.double()).abs().max())
            fail(f"{name}: the output from the files differs from the in-memory run by {diff}")
        for a, b in zip(out.ct.affines, want.ct.affines, strict=True):
            if not np.array_equal(a.data, b.data):
                fail(f"{name}: the output affine from the files differs from the in-memory run")
        del memory, want
        # the host read of one series, alone
        series_reads = []
        for _ in range(2):
            t0 = time.perf_counter()
            dicom.read_dicom_dir(series[0])
            series_reads.append(time.perf_counter() - t0)
        tio.seed(CT_SEED)
        events = device_events(torch, lambda: pipeline(read_batch()))
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
        top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in top)
        times = [r + c for r, c in zip(read_times, call_times)]
        report_path(name, times, peak, per_call, ("resample",), smi, "series", CT_B, CT_WARMUP)
        timed_reads, timed_calls = read_times[CT_WARMUP:], call_times[CT_WARMUP:]
        print(
            f"{name}: {CT_B} series of {CT_SHAPE} int16 ({CT_SHAPE[2]} files of"
            f" {CT_SHAPE[0] * CT_SHAPE[1] * 2 // 1024} KiB each) read equal to the volumes written,"
            f" affine within {affine_err:.3g} mm (limit {CT_AFFINE_ATOL}); read (parse and sort on the"
            f" host, copy to the card) median {statistics.median(timed_reads) * 1e3:.1f} ms a call,"
            f" pipeline median {statistics.median(timed_calls) * 1e3:.1f} ms a call (reads"
            f" {[round(t * 1e3, 1) for t in read_times]} ms, pipelines"
            f" {[round(t * 1e3, 1) for t in call_times]} ms); host read of one series (read_dicom_dir,"
            f" this machine's host CPU) {[round(t * 1e3, 1) for t in series_reads]} ms; device time a"
            f" call (read + pipeline, profiler) {device_ms:.3f} ms (largest, ms: {top}); launches a call {expected};"
            f" output equal to the in-memory run bit for bit; series made and written in"
            f" {setup_s:.2f} s (set-up); card {smi}"
        )
        if profile:
            profile_same_draws(torch, tio, CT_SEED, pipeline, read_batch(), profile, f"{name} (pipeline)")
    return totals, volumes[0], written


def pixel_fragments(raw):
    """The encapsulated PixelData's frames of one DICOM file's bytes (the
    basic offset table dropped)."""
    at = raw.index(b"\xe0\x7f\x10\x00OB\x00\x00\xff\xff\xff\xff") + 12
    frames = []
    while True:
        group, element, length = struct.unpack_from("<HHI", raw, at)
        at += 8
        if (group, element) == (0xFFFE, 0xE0DD):
            return frames[1:]
        frames.append(raw[at : at + length])
        at += length


def phase_ct_codecs(torch, np, tio, native, smi, volume, affine):
    """The compressed syntaxes on CT_CODEC_SLICES slices of the CT volume:
    RLE, JPEG Lossless SV1 and JPEG-LS lossless, each written by the
    port's writer as a series and as one multi-frame file and read lazily
    onto the card, bit-equal to the slices; each JPEG frame decoded once
    by the native library, nothing declined, equal to the Python
    decoder's."""
    name = "ct-dicom-codecs"
    dicom = importlib.import_module("torchio_tpu_torch.io.dicom")
    stack = np.ascontiguousarray(volume[..., :CT_CODEC_SLICES])
    want = torch.from_numpy(stack).to(DEVICE)
    lines = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as tmp:
        for compression, codec in CT_CODECS.items():
            series, single = Path(tmp) / compression, Path(tmp) / f"{compression}.dcm"
            t0 = time.perf_counter()
            dicom.write_dicom_series(series, stack, affine, compression=compression)
            dicom.write_dicom(single, stack, affine, compression=compression)
            encode_s = time.perf_counter() - t0
            reads = {}
            for label, path in (("series", series), ("file", single)):
                native.reset_calls()
                t0 = time.perf_counter()
                image = tio.ScalarImage(path)
                image.load()
                reads[label] = time.perf_counter() - t0
                if image.data.device.type != DEVICE or not torch.equal(image.data, want):
                    fail(f"{name}: {compression} {label} read back differs from the slices written")
                if codec and (native.CALLS[f"{codec}_decode"], native.CALLS[f"{codec}_declined"]) != (
                    CT_CODEC_SLICES, 0
                ):
                    fail(f"{name}: {compression} {label}: native calls {native.CALLS}, expected one a frame")
            frames = pixel_fragments(single.read_bytes())
            series_frames = [f for p in sorted(series.iterdir()) for f in pixel_fragments(p.read_bytes())]
            if frames != series_frames or len(frames) != CT_CODEC_SLICES:
                fail(f"{name}: {compression}: the file's frames differ from the series'")
            line = (
                f"{compression}: {sum(len(f) for f in frames) / stack.nbytes:.3f} of the raw bytes,"
                f" encoded (series and file) in {encode_s:.2f} s (set-up); host read of the series"
                f" {reads['series'] * 1e3:.1f} ms, of the file {reads['file'] * 1e3:.1f} ms"
            )
            if codec:
                decode = getattr(native, f"{codec}_decode")
                plain = getattr(native, f"{codec}_decode_plain")
                native_s, plain_s = [], []
                for frame in frames:
                    t0 = time.perf_counter()
                    got = decode(frame)
                    native_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    reference = plain(frame)
                    plain_s.append(time.perf_counter() - t0)
                    if not np.array_equal(got, reference):
                        fail(f"{name}: {compression}: a native frame differs from the Python decoder's")
                line += (
                    f"; a frame: native {statistics.median(native_s) * 1e3:.2f} ms, Python"
                    f" {statistics.median(plain_s) * 1e3:.1f} ms, equal"
                )
            lines.append(line)
    print(
        f"{name}: {CT_CODEC_SLICES} slices of {CT_SHAPE[0]}x{CT_SHAPE[1]} int16 as a series and as one"
        f" multi-frame file in each syntax, read onto the card equal to the slices, one native decode a"
        f" JPEG frame, none declined (host times, this machine's host CPU): {'; '.join(lines)}; card {smi}"
    )


class TimedSubject:
    """A Subject whose ``load`` records its thread and its interval (the
    Queue's reads), as a mixin on the port's Subject class."""

    log: list = []
    lock = threading.Lock()

    def load(self):
        loaded = all(image.is_loaded for image in self.images.values())
        t0 = time.perf_counter()
        super().load()
        if not loaded:
            with TimedSubject.lock:
                TimedSubject.log.append((threading.current_thread().name, t0, time.perf_counter()))


def overlapped_seconds(log):
    """Seconds during which two loads of different threads ran at once."""
    total = 0.0
    for (thread_a, a0, a1), (thread_b, b0, b1) in itertools.combinations(log, 2):
        if thread_a != thread_b:
            total += max(0.0, min(a1, b1) - max(a0, b0))
    return total


def write_config5_files(torch, tio, directory):
    """config5_subjects' volumes as uncompressed ``.nii`` (float32 t1,
    int32 seg): a list of (t1 path, seg path)."""
    subjects = config5_subjects(tio, torch, CONFIG5_SUBJECTS, CONFIG5_SHAPE, torch.device(DEVICE), 0)
    paths = []
    for i, subject in enumerate(subjects):
        t1, seg = directory / f"c5_{i}_t1.nii", directory / f"c5_{i}_seg.nii"
        tio.io.write_nifti(t1, subject.t1.data, subject.t1.affine.data)
        if i == 0:
            tio.io.write_nifti(seg, subject.seg.data, subject.seg.affine.data)
        else:  # the same block labels in every subject: a copy of the first file
            shutil.copyfile(paths[0][1], seg)
        paths.append((t1, seg))
    return paths


def phase_config5_nifti_queue(torch, tio, kl, native, smi, in_memory_locations, profile: str | None):
    """config5-nifti-queue: config5-queue-labelsampler over subjects stored
    as uncompressed ``.nii`` and read by the Queue's workers; every epoch
    reads from disk (``Subject.unload()`` between epochs). The patch
    corners must equal the in-memory run's on the same seeds, and the
    dense resample kernel must launch once for each subject that kept
    Motion."""
    name = "config5-nifti-queue"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c5_") as tmp:
        t0 = time.perf_counter()
        paths = write_config5_files(torch, tio, Path(tmp))
        write_s = time.perf_counter() - t0
        subject_class = type("TimedPortSubject", (TimedSubject, tio.Subject), {})
        subjects = [
            subject_class(t1=tio.ScalarImage(t1), seg=tio.LabelMap(seg), sid=sid)
            for sid, (t1, seg) in enumerate(paths)
        ]
        queue = config5_queue(tio, subjects, CONFIG5_PATCH, CONFIG5_WORKERS)
        recorder = queue.transform
        centres, locations, epoch_times, read_seconds = [], [], [], []

        def epoch():
            for subject in subjects:
                subject.unload()
            before = len(TimedSubject.log)
            t0 = time.perf_counter()
            for batch in queue.device_batches(batch_size=CONFIG5_BATCH):
                batch.images["t1"].data.sum().item()
                centres.append(patch_centres(batch, CONFIG5_BATCH, CONFIG5_PATCH, name))
                locations.append(batch_locations(batch))
            epoch_times.append(time.perf_counter() - t0)
            read_seconds.append(sum(b - a for _, a, b in TimedSubject.log[before:]))

        TimedSubject.log.clear()
        random.seed(CONFIG5_SEED)
        tio.seed(CONFIG5_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_calls()
        kl.reset_launches()
        for _ in range(CONFIG5_WARMUP + CONFIG5_TIMED):
            epoch()
        launches = {k: kl.LAUNCHES[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        calls = dict(native.CALLS)
        log = list(TimedSubject.log)
        check_native(native, name)
        check_centres(torch, centres, name)
        if locations != in_memory_locations:
            fail(f"{name}: patch corners differ from config5-queue-labelsampler's on the same seeds")
        prepared = (CONFIG5_WARMUP + CONFIG5_TIMED) * CONFIG5_SUBJECTS
        kept = recorder.motion_kept()
        if len(recorder.histories) != prepared or not kept or launches["resample_coords"] != kept:
            fail(f"{name}: {launches['resample_coords']} dense resample launches, Motion kept {kept}"
                 f" times in {len(recorder.histories)} subjects (expected {prepared})")
        others = {k: v for k, v in launches.items() if v and k != "resample_coords"}
        if others:
            fail(f"{name}: launched kernels off its path: {others}")
        if len(log) != prepared:
            fail(f"{name}: {len(log)} subject reads, expected {prepared} (one a subject an epoch)")
        main = threading.main_thread().name
        in_workers = sum(thread != main for thread, _, _ in log)
        if in_workers < prepared - (CONFIG5_WARMUP + CONFIG5_TIMED):
            fail(f"{name}: {in_workers} of {prepared} reads in worker threads")
        overlap = overlapped_seconds(log)
        if overlap <= 0:
            fail(f"{name}: the worker threads' reads never overlapped")
        if any(subject.t1.data.device.type != DEVICE for subject in subjects):
            fail(f"{name}: a subject's data did not end on the card")
        timed = epoch_times[CONFIG5_WARMUP:]
        patches = CONFIG5_SUBJECTS * CONFIG5_PER_VOLUME * CONFIG5_TIMED
        print(
            f"{name}: {patches / sum(timed):.2f} patches/s over {CONFIG5_TIMED} timed epochs"
            f" ({CONFIG5_SUBJECTS} subjects of a float32 t1 and an int32 seg of {CONFIG5_SHAPE[0]}^3 as"
            f" .nii, read from disk every epoch by {CONFIG5_WORKERS} workers; after {CONFIG5_WARMUP}"
            f" warm-up epochs); epochs {[round(t * 1e3, 1) for t in epoch_times]} ms; reads a"
            f" subject median {statistics.median(b - a for _, a, b in log) * 1e3:.1f} ms, summed per"
            f" epoch {[round(t * 1e3, 1) for t in read_seconds]} ms, {in_workers} of {len(log)} in"
            f" worker threads, overlapping for {overlap * 1e3:.1f} ms in all; dense resample launches"
            f" {launches['resample_coords']} = subjects that kept Motion ({kept} of {prepared}); patch"
            f" corners equal to config5-queue-labelsampler's; native calls {calls}; peak allocated"
            f" {peak / 2**30:.2f} GiB; files written in {write_s:.2f} s (set-up); card {smi}"
        )
        if profile:
            profile_calls(torch, lambda _: epoch(), None, profile, f"{name} (an epoch a call, reads included)")
    return launches


def device_events(torch, fn):
    """The profiler's device events (summed by name) of one ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]


def device_kernels(torch, fn):
    """The number of kernels the card ran in one ``fn()``."""
    return sum(e.count for e in device_events(torch, fn))


def phase_zoo_timing(torch, tio, smi):
    """One timed call each at full width: KeepLargestComponent on the
    brats cell's seg with a stray island a label (its host time and its
    two copies), and Swap(patch_size=15, num_iterations=100) on B=4 x
    256^3 (its device kernels a call)."""
    dev = torch.device(DEVICE)
    batch = make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0)
    batch.seg.data = islands_seg(torch, batch.seg.data)
    seg = batch.seg.data
    transform = tio.KeepLargestComponent()
    transform(copy.deepcopy(batch))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = transform(batch)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = seg.cpu()
    pull_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host.to(dev)
    torch.cuda.synchronize()
    push_s = time.perf_counter() - t0
    kept = out.seg.data
    changed = kept != seg
    if kept.device.type != DEVICE or kept.dtype != torch.int32:
        fail(f"KeepLargestComponent: {kept.dtype} on {kept.device}")
    if not bool(changed.any()) or bool((kept[changed] != 0).any()):
        fail(f"KeepLargestComponent: {int(changed.sum())} voxels changed, not all to 0")
    print(
        f"KeepLargestComponent (B={BRATS_B} x {'x'.join(map(str, BRATS_SHAPE))} int32, a stray"
        f" island a label): {int(changed.sum())} voxels removed; {call_s * 1e3:.1f} ms a"
        f" call, of which the copies to the host"
        f" {pull_s * 1e3:.1f} ms and back {push_s * 1e3:.1f} ms (timed alone), host"
        f" {(call_s - pull_s - push_s) * 1e3:.1f} ms; card {smi}"
    )
    del batch, out, seg, kept, host, changed

    batch = make_batch(tio, torch, SWAP_B, SWAP_SHAPE, dev, 1)
    swap = tio.Swap(patch_size=SWAP_PATCH, num_iterations=SWAP_ITERATIONS)
    tio.seed(0)
    swap(batch)  # warm-up
    torch.cuda.synchronize()
    tio.seed(1)
    t0 = time.perf_counter()
    out = swap(batch)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    params = out.applied_transforms[0].params
    steps = max(len(locations) for locations in params["locations"])
    tio.seed(1)
    kernels = device_kernels(torch, lambda: swap(batch))
    if not bool(torch.isfinite(out.t1.data).all()) or torch.equal(out.t1.data, batch.t1.data):
        fail("Swap: the output is not finite or equals the input")
    print(
        f"Swap(patch_size={SWAP_PATCH}, num_iterations={SWAP_ITERATIONS}) on B={SWAP_B} x"
        f" {'x'.join(map(str, SWAP_SHAPE))}: {call_s * 1e3:.1f} ms a call, {steps} steps,"
        f" {kernels} device kernels a call (4 a step: two gathers, two scatters); card {smi}"
    )


# --- ux: warm-up, profiling, the command line, figures and adapters -----------

UX_SEED = 0
#: what warmup of the headline launches (one call at p=1): the resample,
#: and BiasField's and Noise's draws
UX_WARMUP_LAUNCHES = {"resample": 1, "threefry_normal": 2}
UX_PROFILE_CALLS = 3


def monai_stand_in(torch):
    """A ``monai`` module of the two symbols MonaiAdapter touches
    (``MetaTensor``, ``MapTransform``), as tests/test_adapters.py builds
    it; neither MONAI nor Cornucopia is installed on the card's machine."""
    import types

    class MetaTensor(torch.Tensor):
        affine = None

        @staticmethod
        def __new__(cls, data, affine=None):
            obj = torch.as_tensor(data).as_subclass(cls)
            obj.affine = affine
            return obj

    class MapTransform:
        pass

    monai = types.ModuleType("monai")
    monai.data = types.ModuleType("monai.data")
    monai.data.MetaTensor = MetaTensor
    monai.transforms = types.ModuleType("monai.transforms")
    monai.transforms.MapTransform = MapTransform
    return {"monai": monai, "monai.data": monai.data, "monai.transforms": monai.transforms}


def ux_warmup(torch, tio, tr, kl, batch):
    """warmup of the headline at B=4 x 256^3: the host RNG state restored,
    its launches, and a seeded call after it bit-equal to one without it."""
    pipeline = headline(tio)
    tio.seed(UX_SEED)
    state = copy.deepcopy(tr.get_rng().bit_generator.state)
    torch.cuda.synchronize()
    kl.reset_launches()
    t0 = time.perf_counter()
    tio.warmup(pipeline, (S, S, S), batch_size=B)
    warm_s = time.perf_counter() - t0
    launched = {k: n for k, n in kl.LAUNCHES.items() if n}
    if launched != UX_WARMUP_LAUNCHES:
        fail(f"ux: warmup launched {launched}, expected {UX_WARMUP_LAUNCHES}")
    if tr.get_rng().bit_generator.state != state:
        fail("ux: warmup changed the host RNG state")
    t0 = time.perf_counter()
    warm = pipeline(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    tio.seed(UX_SEED)
    cold = pipeline(batch)
    if not torch.equal(warm.t1.data, cold.t1.data):
        fail("ux: a seeded headline call after warmup differs from one without it")
    print(
        f"ux warmup: tio.warmup(headline, {S}^3, batch_size={B}) {warm_s:.3f} s (the kernels"
        f" already built by this process), launches {launched}; the first call after it"
        f" {first_s * 1e3:.1f} ms; host RNG state restored; the seeded call after it bit-equal to"
        " one without it"
    )
    return launched


def ux_profile(torch, tio, kl, batch, directory):
    """profiling.profile around UX_PROFILE_CALLS headline calls, then
    profiling.trace around one: the trace names the resample and threefry
    kernels."""
    pipeline = headline(tio)
    original = tio.Transform.forward
    torch.cuda.synchronize()
    kl.reset_launches()
    t0 = time.perf_counter()
    with tio.profiling.profile() as prof:
        for _ in range(UX_PROFILE_CALLS):
            pipeline(batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: n for k, n in kl.LAUNCHES.items() if n}
    if tio.Transform.forward is not original:
        fail("ux: profile() did not restore Transform.forward")
    # the fused Compose times Spatial (BiasField + Noise run in its fused
    # stage), as tests/test_torch_profiling.py pins for the same Compose
    counts = {name: len(times) for name, times in prof.records.items()}
    if counts != {"Spatial": UX_PROFILE_CALLS}:
        fail(f"ux: profile recorded {counts}")
    timed = sum(prof.total(name) for name in prof.records)
    if not 0 < timed <= wall:
        fail(f"ux: profiled {timed:.4f} s of transforms in {wall:.4f} s of calls")
    if launched != {k: UX_PROFILE_CALLS * n for k, n in UX_WARMUP_LAUNCHES.items()}:
        fail(f"ux: the profiled calls launched {launched}")
    trace_dir = directory / "trace"
    with tio.profiling.trace(str(trace_dir)):
        pipeline(batch)
    (path,) = trace_dir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    resample = [k for k in kernels if "row_kernel" in k and "Resample" in k]
    threefry = [k for k in kernels if "threefry::segments_kernel" in k]
    if not resample or not threefry:
        fail(f"ux: the trace names no resample or threefry kernel: {kernels}")
    print(
        f"ux profile: {UX_PROFILE_CALLS} headline calls in {wall * 1e3:.1f} ms, transforms timed"
        f" {timed * 1e3:.1f} ms; report:\n{prof.report()}\nux profile: launches {launched};"
        f" trace {path.stat().st_size} bytes, {len(kernels)} kernel names, among them"
        f" {resample[0]!r} and {threefry[0]!r}"
    )
    return launched


def ux_cli(torch, np, tio, kl, directory):
    """The command line in subprocesses on one IXI t1 (.nii.gz): transform
    Affine (bit-equal to the same transform in this process from the same
    seed), info --load, convert to .nrrd (reads back equal)."""
    dev = torch.device(DEVICE)
    source = directory / "ixi_t1.nii.gz"
    t1 = ixi_int16(torch, 1, IXI_SHAPE, dev, IXI_SEED)[0]
    tio.io.write_nifti(source, t1, stored_affine(np, IXI_SPACING, IXI_CODES))
    out, nrrd = directory / "affine.nii.gz", directory / "t1.nrrd"
    commands = {
        "transform": ["transform", "Affine", str(source), str(out), "degrees=10", "--seed", "0"],
        "info": ["info", str(source), "--load"],
        "convert": ["convert", str(source), str(nrrd)],
    }
    seconds, procs = {}, {}

    def run(name):  # the three commands at once: each process takes seconds to start
        t0 = time.perf_counter()
        procs[name] = subprocess.run(
            [sys.executable, "-m", "torchio_tpu_torch.cli", *commands[name]],
            capture_output=True, text=True, timeout=300,
        )
        seconds[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(name,)) for name in commands]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    for name, proc in procs.items():
        if proc.returncode != 0:
            fail(f"ux: cli {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
    stdout = {name: proc.stdout for name, proc in procs.items()}
    if f"shape:       (1, {', '.join(map(str, IXI_SHAPE))})" not in stdout["info"]:
        fail(f"ux: cli info printed {stdout['info']!r}")
    kl.reset_launches()
    tio.seed(0)
    want = tio.Affine(degrees=10)(tio.ScalarImage(source))
    launched = {k: n for k, n in kl.LAUNCHES.items() if n}
    got = tio.ScalarImage(out)
    if want.data.device.type != DEVICE or not torch.equal(got.data, want.data):
        fail("ux: cli transform Affine differs from the same transform run in this process")
    if not np.allclose(got.affine.data, want.affine.data, rtol=0, atol=1e-6):
        fail("ux: cli transform Affine wrote another affine")
    if not torch.equal(tio.ScalarImage(nrrd).data, t1):
        fail("ux: cli convert to .nrrd reads back different data")
    if launched != {"resample": 1}:
        fail(f"ux: Affine launched {launched}")
    print(
        "ux cli: subprocess seconds (python -m torchio_tpu_torch.cli, the three at once, the interpreter"
        f" and the card included) {', '.join(f'{k} {v:.2f}' for k, v in seconds.items())}; transform Affine"
        f" bit-equal to the same call in this process (launches {launched}); info:"
        f" {stdout['info'].strip().splitlines()[-1]!r}; convert reads back equal"
    )
    return launched


def ux_figures(torch, np, tio, directory):
    """Figures of a 256^3 t1 and an int32 seg on the card against the same
    subject on the CPU. The device side of a figure needs no drawing
    library and always runs: the three planes of the RAS view, the
    display window's percentiles, a label map's range, a sweep's uint8
    frames, and what each copies to the host. The drawing runs where its
    library is installed: plot_subject's RGBA with matplotlib, make_gif's
    file with Pillow. The subject's notebook card runs either way (without a
    drawing library it has no preview)."""
    from torchio_tpu_torch import visualization as viz

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(UX_SEED)
    t1 = torch.rand((1, S, S, S), generator=gen, device=dev)
    seg = suite_labels(torch, (S, S, S), dev)
    card = tio.Subject(t1=tio.ScalarImage(t1), seg=tio.LabelMap(seg))
    host = tio.Subject(t1=tio.ScalarImage(t1.cpu()), seg=tio.LabelMap(seg.cpu()))
    for name in ("t1", "seg"):
        got, want = (viz._RasView(s[name]) for s in (card, host))
        indices = tuple(n // 2 for n in got.shape_ras)
        for a, b in zip(got.planes(indices, 0), want.planes(indices, 0), strict=True):
            if a.shape != b.shape or not (a == b).all():
                fail(f"ux: a plane of {name} on the card differs from the CPU's")
    got, want = (viz._percentiles(s.t1.data, (0.5, 99.5)) for s in (card, host))
    if not np.array_equal(got, want):
        fail(f"ux: the display window on the card {got} differs from the CPU's {want}")
    if int(viz._scalars(card.seg.data.max())[0]) != int(seg.max()):
        fail("ux: the label range read from the card is wrong")
    viz.HOST_COPIES.update(copies=0, bytes=0)
    t0 = time.perf_counter()
    view = viz._RasView(card.t1)
    view.planes(tuple(n // 2 for n in view.shape_ras), 0)
    viz._percentiles(view.source, (0.5, 99.5))
    data_ms = (time.perf_counter() - t0) * 1e3
    figure_copies = dict(viz.HOST_COPIES)
    viz.HOST_COPIES.update(copies=0, bytes=0)
    t0 = time.perf_counter()
    frames = viz._sweep_frames(card.t1, 2, None, False)
    frames_ms = (time.perf_counter() - t0) * 1e3
    frame_copies = dict(viz.HOST_COPIES)
    cpu_frames = viz._sweep_frames(host.t1, 2, None, False)
    if len(frames) != S or any(not np.array_equal(a, b) for a, b in zip(frames, cpu_frames, strict=True)):
        fail("ux: the sweep's frames on the card differ from the CPU's")
    found = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "PIL")}
    drawn = "the drawing not run: " + ", ".join(m for m, ok in found.items() if not ok) + " not installed"
    if found["matplotlib"]:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        buffers = []
        for subject, name in ((card, "card"), (host, "cpu")):
            fig = viz.plot_subject(subject, show=False, output_path=directory / f"{name}.png")
            fig.canvas.draw()
            buffers.append(np.asarray(fig.canvas.buffer_rgba()).copy())
            plt.close(fig)
        if buffers[0].shape != buffers[1].shape or not (buffers[0] == buffers[1]).all():
            fail("ux: plot_subject on the card differs from the CPU's")
        t0 = time.perf_counter()
        plt.close(viz.plot_image(card.t1, show=False, output_path=directory / "t1.png"))
        drawn = f"plot_subject RGBA equal to the CPU's; plot_image {(time.perf_counter() - t0) * 1e3:.1f} ms"
    if found["PIL"]:
        files = [
            viz.make_gif(s.t1, directory / f"{name}.gif", axis=2).read_bytes()
            for s, name in ((card, "card"), (host, "cpu"))
        ]
        if files[0] != files[1]:
            fail("ux: make_gif on the card differs from the CPU's")
        drawn += "; make_gif(axis=2) file equal to the CPU's"
    html = card._repr_html_()
    memory = f"{4 * S**3 / 2**20:.1f} MiB"  # 64.0 MiB at 256^3, as _human_bytes formats it
    if "<td>error</td>" in html or f"<td>memory</td><td><code>{memory}</code></td>" not in html:
        fail(f"ux: the subject's notebook card has an error row or a memory row other than {memory}")
    print(
        f"ux figures (t1 1 x {S}^3 float32 + int32 seg): the planes, window and label range on the"
        f" card equal to the CPU's; a figure's data {data_ms:.1f} ms on the host, {figure_copies['copies']}"
        f" copies of {figure_copies['bytes']} bytes to the host (of a {4 * S**3}-byte volume); the"
        f" sweep's {len(frames)} frames (axis 2) equal to the CPU's, {frames_ms:.1f} ms on the card,"
        f" copies {frame_copies}; {drawn}; _repr_html_ {len(html)} characters, memory row {memory},"
        f" preview {'embedded' if 'data:image/png' in html else 'left out'}"
    )
    return card


def ux_adapters(torch, tio, subject):
    """CornucopiaAdapter with a callable that asserts its tensors are on the
    card, MonaiAdapter with the test's stand-in monai module: both flip k,
    equal to torch.flip on the card."""
    def flip_on_card(*tensors):
        for t in tensors:
            if t.device.type != DEVICE:
                fail(f"ux: CornucopiaAdapter handed over a tensor on {t.device}")
        return tuple(torch.flip(t, (-1,)) for t in tensors)

    saved = {name: sys.modules.get(name) for name in ("monai", "monai.data", "monai.transforms")}
    stand_in = monai_stand_in(torch)
    sys.modules.update(stand_in)
    try:
        map_transform = stand_in["monai.transforms"].MapTransform

        class FlipK(map_transform):
            def __call__(self, data):
                return {
                    k: torch.flip(v, (-1,)) for k, v in data.items() if isinstance(v, torch.Tensor)
                }

        outs = {
            "cornucopia": tio.CornucopiaAdapter(flip_on_card)(subject),
            "monai": tio.MonaiAdapter(FlipK())(subject),
        }
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    for adapter, out in outs.items():
        for name in ("t1", "seg"):
            data = out[name].data
            if data.device.type != DEVICE or not torch.equal(data, torch.flip(subject[name].data, (-1,))):
                fail(f"ux: {adapter} adapter's {name} is not torch.flip on the card")
    print("ux adapters: CornucopiaAdapter and MonaiAdapter (stand-in monai) equal to torch.flip on the card")


def phase_ux(torch, np, tio, tr, kl):
    """The tools around a pipeline on the card, each held to what the CPU
    tests pin: warmup, profiling, the command line, figures and notebook
    cards, the adapters."""
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, 0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ux_") as tmp:
        directory = Path(tmp)
        launches = {
            "warmup": ux_warmup(torch, tio, tr, kl, batch),
            "profile": ux_profile(torch, tio, kl, batch, directory),
            "cli transform Affine (in process)": ux_cli(torch, np, tio, kl, directory),
        }
        del batch
        subject = ux_figures(torch, np, tio, directory)
        ux_adapters(torch, tio, subject)
    print(f"ux: {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


#: the parallel phase (torch.distributed): a one-rank NCCL group, the
#: headline's seed, the simulated space layouts and the large volume
PARALLEL_SEED = 5
PARALLEL_ATOL = 1e-4
PARALLEL_LAYOUTS = (2, 4)
#: the grid-spec draws of the simulated shards: the headline's ranges at
#: (1, 2), and within +-3 degrees (a halo of about 30 rows, which a 64-row
#: slab of the (1, 4) layout holds; the headline's draws need about 70)
SIMULATED_DRAWS = {2: (10.0, 5.0, 3.0), 4: (3.0, 2.0, 1.0)}
PARALLEL_PATCH, PARALLEL_OVERLAP = 64, 16
LARGE_SHAPE, LARGE_SIGMA = (512, 512, 256), 1.5
PARALLEL_RTOL = 1e-6
#: the global draw of the counter-base check and its layouts (data, space)
COUNTER_LAYOUTS = ((2, 2), (4, 1))
PARENT_THREEFRY = Path(__file__).resolve().parent / "probes" / "threefry_parent.cu"
PARENT_BUILD: dict = {}


def start_parent_threefry(kl, config):
    """Start nvcc on the threefry kernel before the counter base (beside
    the package's builds): the parallel phase times both in one process."""
    import hashlib

    digest = hashlib.sha256(" ".join(kl.FLAGS).encode() + PARENT_THREEFRY.read_bytes())
    path = config.BUILD_DIR / f"libthreefry_parent-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        config.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [config.nvcc(), *kl.FLAGS, "-o", str(tmp), str(PARENT_THREEFRY)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        PARENT_BUILD.update(proc=proc, tmp=tmp)
    PARENT_BUILD["path"] = path


def parent_threefry():
    """The parent kernel's library (its nvcc joined) and its launch."""
    import ctypes

    proc = PARENT_BUILD.pop("proc", None)
    if proc is not None:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc failed on {PARENT_THREEFRY.name}:\n{output}")
        os.replace(PARENT_BUILD.pop("tmp"), PARENT_BUILD["path"])
    lib = ctypes.CDLL(str(PARENT_BUILD["path"]))
    lib.tio_threefry_segments.restype = ctypes.c_int
    lib.tio_threefry_segments.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]

    class Row(ctypes.Structure):  # the parent's 88-byte Segment
        _fields_ = [
            ("k0", ctypes.c_uint32), ("k1", ctypes.c_uint32), ("inject", ctypes.c_uint32 * 10),
            ("offset", ctypes.c_longlong), ("count", ctypes.c_longlong),
            ("start", ctypes.c_longlong), ("scale", ctypes.c_float),
            ("first_block", ctypes.c_int), ("blocks", ctypes.c_int),
        ]

    if ctypes.sizeof(Row) != 88:
        fail(f"the parent's segment row is {ctypes.sizeof(Row)} bytes, not 88")
    return lib, Row


class GatherSpy:
    """While active, records every gather a rank could make (the
    torch.distributed all-gathers, ``DTensor.full_tensor``/``redistribute``)
    with the transform running when it happened (``inside``: Spatial, each
    of ``stages``, any stage a pipeline applies, or a fused run as its
    stages' names joined by "+"), and every stage or fused run that
    entered ``data.batch.gathered`` (``entered``)."""

    def __init__(self, torch, tio, stages=()):
        self.torch, self.tio = torch, tio
        self.stages = list(stages)
        self.gathers: list[tuple[str, str | None]] = []
        self.entered: list[str | None] = []
        self.current: str | None = None

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor

        self._saved = []

        def wrap(owner, name, record):
            real = getattr(owner, name)

            def spy(*args, **kwargs):
                record(name)
                return real(*args, **kwargs)

            self._saved.append((owner, name, real))
            setattr(owner, name, spy)

        for name in ("all_gather", "all_gather_into_tensor", "all_gather_object"):
            wrap(dist, name, lambda n: self.gathers.append((n, self.current)))
        for name in ("full_tensor", "redistribute"):
            wrap(DTensor, name, lambda n: self.gathers.append((f"DTensor.{n}", self.current)))
        spatial = self.tio.Spatial
        real_apply = spatial.apply_transform

        def apply(transform, batch, params):
            self.current = type(transform).__name__
            try:
                return real_apply(transform, batch, params)
            finally:
                self.current = None

        self._saved.append((spatial, "apply_transform", real_apply))
        spatial.apply_transform = apply
        for stage in self.stages:
            for hook in ("make_params", "apply_transform"):
                self._label(stage, hook)
        from torchio_tpu_torch.transforms import fuse as fuse_mod
        from torchio_tpu_torch.transforms import transform as transform_mod

        real_gathered = transform_mod.gathered

        def gathered(batch):
            self.entered.append(self.current)
            return real_gathered(batch)

        def named(owner, name, label):
            real = getattr(owner, name)

            def call(first, second):
                outer, self.current = self.current, label(first, second)
                try:
                    return real(first, second)
                finally:
                    self.current = outer

            self._saved.append((owner, name, real))
            setattr(owner, name, call)

        for owner in (transform_mod, fuse_mod):
            self._saved.append((owner, "gathered", real_gathered))
            owner.gathered = gathered
        named(transform_mod, "apply_drawn", lambda transform, batch: type(transform).__name__)
        named(fuse_mod, "run_fused",
              lambda batch, stages: "+".join(type(t).__name__ for t, _ in stages))
        return self

    def _label(self, stage, hook):
        """``stage.hook`` (on the instance) runs with ``current`` set to
        the stage's class name."""
        real = getattr(stage, hook)

        def labelled(*args, **kwargs):
            outer, self.current = self.current, type(stage).__name__
            try:
                return real(*args, **kwargs)
            finally:
                self.current = outer

        setattr(stage, hook, labelled)
        self._saved.append((stage, hook, None))

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            if real is None:
                delattr(owner, name)
            else:
                setattr(owner, name, real)

    def inside(self, name: str) -> list[str]:
        return [g for g, where in self.gathers if where == name]


def nccl_mesh(torch):
    """A one-rank NCCL group (a TCP store on this host) and its (1, 1)
    mesh on the card."""
    import socket

    import torch.distributed as dist

    from torchio_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    if dist.get_backend() != "nccl":
        fail(f"the process group runs {dist.get_backend()}, not nccl")
    return make_mesh(DEVICE)


def rel_close(torch, got, want, rtol):
    err = (got - want).abs()
    return bool((err <= rtol * want.abs() + rtol).all()), float(err.max())


def simulated_slab(halo_mod, x, j0, jl, width, edge):
    """A shard's halo-extended slab as the exchange would give it: its
    neighbours' rows sliced from the global volume, zeros (or the edge)
    past the global ends."""
    sj = x.shape[3]
    left = x[:, :, :, j0 - width:j0] if j0 > 0 else None
    right = x[:, :, :, j0 + jl:j0 + jl + width] if j0 + jl < sj else None
    return halo_mod.extend(x[:, :, :, j0:j0 + jl], left, right, width, edge=edge)


def grid_maps(np, b, shape, degrees, translation, displacement, seed):
    """Headline-like grid specs on the host: per element a rotation about
    the centre of up to ``degrees`` on each axis, a scale in [0.9, 1.1], a
    translation of up to ``translation`` voxels, and a 7^3 coarse field of
    up to ``displacement`` voxels (borders held at zero)."""
    rng = np.random.default_rng(seed)
    centre = (np.asarray(shape, np.float64) - 1) / 2
    maps, fields = [], []
    for _ in range(b):
        m = rot(*np.deg2rad(rng.uniform(-degrees, degrees, 3)), scale=rng.uniform(0.9, 1.1),
                shift=rng.uniform(-translation, translation, 3), center=centre)
        field = rng.uniform(-displacement, displacement, (7, 7, 7, 3)).astype(np.float32)
        field[[0, -1]] = field[:, [0, -1]] = field[:, :, [0, -1]] = 0.0
        maps.append(m)
        fields.append(field)
    return maps, fields


def parallel_headline(torch, tio, kl, mesh, smi):
    """The headline on ``SubjectsBatch.shard_(mesh, spatial=True)``:
    Spatial through the halo program (one dense-coordinate launch, no
    grid-spec launch, no fallback), BiasField + Noise on the region, no
    gather anywhere in the call, within 1e-4 of the unsharded call on the
    same seed."""
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, PARALLEL_SEED)
    tio.seed(PARALLEL_SEED)
    ref = headline(tio)(copy.deepcopy(batch)).images["t1"].data
    sharded = copy.deepcopy(batch).shard_(mesh, spatial=True)
    kl.reset_launches()
    tio.seed(PARALLEL_SEED)
    with warnings.catch_warnings(record=True) as caught, GatherSpy(torch, tio) as spy:
        warnings.simplefilter("always")
        out = headline(tio)(sharded)
        torch.cuda.synchronize()
    launches = dict(kl.LAUNCHES)
    fallbacks = [str(w.message) for w in caught if "fell back" in str(w.message)]
    data = out.images["t1"].data
    if not is_dtensor(data) or data.device_mesh != mesh or out.images["t1"].sharding is None:
        fail(f"parallel headline: the output is not a DTensor on the mesh ({type(data)})")
    if launches["resample_coords"] != 1 or launches["resample"] != 0:
        fail(f"parallel headline: Spatial's launches {launches}, expected 1 resample_coords,"
             " 0 resample")
    if launches["threefry_normal"] != THREEFRY_LAUNCHES["headline"]:
        fail(f"parallel headline: threefry launches {launches['threefry_normal']}")
    if spy.gathers or fallbacks:
        fail(f"parallel headline: gathered {spy.gathers} or fell back {fallbacks}")
    err = float((data.full_tensor() - ref).abs().max())
    if not err <= PARALLEL_ATOL:
        fail(f"parallel headline: max abs {err} against the unsharded call")
    times = {}
    for name, make in (("sharded", lambda: copy.deepcopy(batch).shard_(mesh, spatial=True)),
                       ("unsharded", lambda: copy.deepcopy(batch))):
        runs = []
        for _ in range(3):
            b = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            headline(tio)(b)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        times[name] = runs
    print(
        f"parallel headline: Compose([Spatial, BiasField, Noise], fuse=True) on B={B} x {S}^3"
        f" shard_(mesh (1, 1), spatial=True): launches {launches}, no gather in the call"
        f" (BiasField + Noise on the region), max abs {err:.3g} against the"
        f" unsharded call; a call {min(times['sharded']) * 1e3:.1f} ms sharded,"
        f" {min(times['unsharded']) * 1e3:.1f} ms unsharded (best of 3, host clock); card: {smi}"
    )
    return launches["resample_coords"], batch


def simulate_resample(torch, np, halo_mod, kl, batch, mesh):
    """``halo_resample_spec``'s local program, each shard of a (1, 2) and a
    (1, 4) layout fed the halos its neighbours would send, reassembled
    against the (1, 1) program."""
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place

    dev = torch.device(DEVICE)
    x = batch.images["t1"].data.to(torch.float32)
    sharding = NamedSharding(mesh, ("data", None, None, "space", None))
    spatial = (S, S, S)
    report, launches = {}, 0
    for n in PARALLEL_LAYOUTS:
        degrees, translation, displacement = SIMULATED_DRAWS[n]
        maps, fields = grid_maps(np, B, spatial, degrees, translation, displacement, 100 + n)
        whole = halo_mod.halo_resample_spec(place(x, sharding), maps, fields,
                                            sharding=sharding, fill=0.0).full_tensor()
        ms = np.stack(maps)
        cps = np.stack(fields)
        jl = S // n
        halo = halo_mod._halo_width(ms, cps, *spatial)
        if halo >= jl:
            fail(f"simulated shards (1, {n}): halo {halo} >= {jl}")
        maps_t = torch.as_tensor(ms.astype(np.float32), device=dev)
        cps_t = torch.as_tensor(cps, device=dev)
        before = kl.LAUNCHES["resample_coords"]
        slabs = []
        for s in range(n):
            ext = simulated_slab(halo_mod, x, s * jl, jl, halo, edge=False)
            planes = halo_mod.spec_planes(maps_t, cps_t, j0=s * jl, jl=jl, spatial=spatial)
            slabs.append(halo_mod.halo_resample_local(
                ext, planes, x.new_zeros((B, C)), j0=s * jl, halo=halo, spatial=spatial,
                mode="linear", apply_fill=False,
            ))
            del ext, planes
        check_launches(kl, "resample_coords", before, n)
        launches += n
        err = float((torch.cat(slabs, dim=3) - whole).abs().max())
        if not err <= PARALLEL_ATOL:
            fail(f"simulated halo_resample_spec (1, {n}): max abs {err}")
        report[f"(1, {n})"] = f"halo {halo}, max abs {err:.3g}"
        del slabs, whole
    return report, launches


def simulate_blur(torch, halo_mod, batch, mesh):
    from torchio_tpu_torch.ops.gaussian import gaussian_kernel_1d, radius_for_sigma
    from torchio_tpu_torch.parallel.mesh import batch_sharding, place

    x = batch.images["t1"].data.to(torch.float32)
    sigma = 2.0
    whole = halo_mod.halo_blur(place(x, batch_sharding(mesh)), sigma, mesh).full_tensor()
    radius = radius_for_sigma(sigma)
    kernel = torch.as_tensor(gaussian_kernel_1d(sigma, radius), device=x.device)
    report = {}
    for n in PARALLEL_LAYOUTS:
        jl = S // n
        slabs = [
            halo_mod.blur_taps(simulated_slab(halo_mod, x, s * jl, jl, radius, edge=True),
                               kernel, jl)
            for s in range(n)
        ]
        err = float((torch.cat(slabs, dim=3) - whole).abs().max())
        if not err <= PARALLEL_ATOL:
            fail(f"simulated halo_blur (1, {n}): max abs {err}")
        report[f"(1, {n})"] = f"radius {radius}, max abs {err:.3g}"
    return report


def simulate_inference(torch, np, halo_mod, batch, mesh):
    """``sharded_grid_inference``'s local program and fold, per shard."""
    from torchio_tpu_torch.parallel import patches as pm
    from torchio_tpu_torch.parallel import sharded_grid_inference
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place

    x = batch.images["t1"].data[:1].to(torch.float32)
    p = (PARALLEL_PATCH,) * 3
    sharding = NamedSharding(mesh, (None, None, None, "space", None))
    whole = sharded_grid_inference(
        place(x, sharding), mesh=mesh, patch_size=p, patch_overlap=PARALLEL_OVERLAP,
        overlap_mode="hann",
    ).full_tensor()
    window = pm.patch_window(p, "hann", x.device)
    corners = pm.grid_corners((S, S, S), p, (PARALLEL_OVERLAP,) * 3)
    report = {}
    for n in PARALLEL_LAYOUTS:
        jl, halo = S // n, p[1]
        per_shard, valid = pm._partition_corners(corners, n, jl)
        sums = []
        for s in range(n):
            ext = simulated_slab(halo_mod, x, s * jl, jl, halo, edge=False)
            local = per_shard[s].copy()
            local[:, 1] += halo - s * jl
            sums.append(pm.accumulate_patches(ext, local, valid[s], p, window))
        slabs = []
        for s in range(n):
            folded = []
            for k in range(2):  # acc, cnt
                left = sums[s - 1][k][:, :, :, -halo:] if s > 0 else None
                right = sums[s + 1][k][:, :, :, :halo] if s < n - 1 else None
                folded.append(pm.fold_local(sums[s][k], left, right, halo))
            slabs.append(folded[0] / torch.clamp(folded[1], min=1e-8))
        err = float((torch.cat(slabs, dim=3) - whole).abs().max())
        if not err <= PARALLEL_ATOL:
            fail(f"simulated sharded_grid_inference (1, {n}): max abs {err}")
        report[f"(1, {n})"] = f"{len(corners)} patches, max abs {err:.3g}"
        del sums, slabs
    return report


def parallel_step(torch, np, tio, kl, mesh):
    """``make_augment_step`` at B x S^3 against the unsharded step."""
    from torchio_tpu_torch.parallel import make_augment_step, sample_step_params, shard_batch
    from torchio_tpu_torch.parallel.step import augment_step

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    data = torch.rand((B, C, S, S, S), generator=gen, device=dev)
    tio.seed(PARALLEL_SEED)
    rotations, shifts = sample_step_params(B, degrees=10.0, translation=2.0)
    step = make_augment_step(mesh)
    sharded = shard_batch(data, mesh)
    kl.reset_launches()
    out = step(sharded, rotations, shifts, 7)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kl.LAUNCHES.items() if v}
    if launches != {"resample_coords": 1, "threefry_normal": 1}:
        fail(f"parallel step: launches {launches}")
    ref = augment_step(data, rotations, shifts, 7, 0.3, 0.05)
    err = float((out.full_tensor() - ref).abs().max())
    if not err <= PARALLEL_ATOL:
        fail(f"parallel step: max abs {err} against the unsharded step")
    ms = cuda_time_ms(torch, lambda: step(sharded, rotations, shifts, 7), 3)
    plain_ms = cuda_time_ms(torch, lambda: augment_step(data, rotations, shifts, 7, 0.3, 0.05), 3)
    print(
        f"parallel step: make_augment_step on B={B} x {S}^3 (mesh (1, 1)): launches {launches},"
        f" max abs {err:.3g} against augment_step; {ms:.2f} ms a call sharded, {plain_ms:.2f} ms"
        " unsharded (CUDA events, 3 calls)"
    )
    return launches


def parallel_inference(torch, np, tio, mesh):
    """``sharded_grid_inference`` of B=1 x S^3 against GridSampler +
    PatchAggregator on the card, hann and average, identity and Conv3d."""
    from torchio_tpu_torch.parallel import sharded_grid_inference
    from torchio_tpu_torch.parallel.mesh import NamedSharding, place

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    volume = torch.rand((1, C, S, S, S), generator=gen, device=dev)
    subject = tio.Subject(t1=tio.ScalarImage(volume[0]))
    sampler = tio.GridSampler(subject, patch_size=PARALLEL_PATCH, patch_overlap=PARALLEL_OVERLAP)
    batch = next(iter(tio.SubjectsLoader(sampler, batch_size=len(sampler))))
    patches, locations = batch.images["t1"].data, batch.metadata["patch_location"]
    torch.manual_seed(PARALLEL_SEED)
    conv = torch.nn.Conv3d(1, 1, 3, padding=1).to(dev)
    deterministic = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    sharded = place(volume, NamedSharding(mesh, (None, None, None, "space", None)))
    report = {}
    try:
        for mode in ("hann", "average"):
            for name, model in (("identity", None), ("conv", lambda t: conv(t).detach())):
                agg = tio.PatchAggregator(subject.spatial_shape, overlap_mode=mode)
                with torch.no_grad():
                    agg.add_batch(patches if model is None else model(patches), locations)
                    want = agg.get_output(device=True)
                    t0 = time.perf_counter()
                    got = sharded_grid_inference(
                        sharded, mesh=mesh, model_fn=model, patch_size=PARALLEL_PATCH,
                        patch_overlap=PARALLEL_OVERLAP, overlap_mode=mode,
                    ).full_tensor()[0]
                    torch.cuda.synchronize()
                ok, err = rel_close(torch, got, want, PARALLEL_RTOL)
                if not ok:
                    fail(f"sharded_grid_inference {mode} {name}: max abs {err}")
                report[f"{mode}/{name}"] = f"{err:.3g}, {(time.perf_counter() - t0) * 1e3:.0f} ms"
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic
    print(
        f"parallel inference: sharded_grid_inference of 1 x {S}^3, {len(sampler)} patches of"
        f" {PARALLEL_PATCH}^3 overlapping by {PARALLEL_OVERLAP}, against GridSampler +"
        f" PatchAggregator on the card (rtol {PARALLEL_RTOL}): max abs and host ms {report}"
    )


def parallel_large(torch, np, tio, mesh, smi):
    """``process_large_volume`` of a 512 x 512 x 256 float32 ``.nii`` with
    a small rotation, an elastic field and a J blur, against the unsharded
    Spatial + J blur; its read, compute and write seconds."""
    import importlib

    from torchio_tpu_torch.io.nifti import read_nifti, write_nifti
    from torchio_tpu_torch.ops.gaussian import gaussian_blur
    from torchio_tpu_torch.ops.resample import resample_fused
    from torchio_tpu_torch.parallel import halo_blur, process_large_volume, write_volume_sharded
    from torchio_tpu_torch.parallel.halo import halo_resample_spec
    from torchio_tpu_torch.parallel.large import shard_volume_from_file
    from torchio_tpu_torch.parallel.mesh import sharding_of

    rng = np.random.default_rng(PARALLEL_SEED)
    volume = rng.random((1, *LARGE_SHAPE), np.float32)
    centre = (np.asarray(LARGE_SHAPE, np.float64) - 1) / 2
    matrix = rot(0.0, 0.0, np.deg2rad(3.0), shift=(1.5, -2.0, 0.5), center=centre)
    field = rng.uniform(-2.0, 2.0, (5, 5, 5, 3)).astype(np.float32)
    dev = torch.device(DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        src, dst, steps = Path(tmp) / "large.nii", Path(tmp) / "out.nii", Path(tmp) / "s.nii"
        write_nifti(src, volume)
        t0 = time.perf_counter()
        sharded = shard_volume_from_file(tio.ScalarImage(src), mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sharded = halo_resample_spec(sharded, [matrix], [field], sharding=sharding_of(sharded))
        sharded = halo_blur(sharded, LARGE_SIGMA, mesh)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        write_volume_sharded(steps, sharded)
        t3 = time.perf_counter()
        out = process_large_volume(src, dst, mesh=mesh, matrix=matrix, control_points=field,
                                   sigma=LARGE_SIGMA)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        got, _ = read_nifti(dst)
    ref = resample_fused(torch.as_tensor(volume, device=dev)[None], [matrix], [field])
    ref = gaussian_blur(ref, (0.0, LARGE_SIGMA, 0.0))
    err = float((torch.as_tensor(np.asarray(got), device=dev) - ref[0, 0]).abs().max())
    if not err <= PARALLEL_ATOL:
        fail(f"process_large_volume: max abs {err} against the unsharded Spatial + J blur")
    if tuple(out.shape) != (1, 1, *LARGE_SHAPE):
        fail(f"process_large_volume: output {tuple(out.shape)}")
    print(
        f"parallel large: process_large_volume of a {'x'.join(map(str, LARGE_SHAPE))} float32"
        f" .nii ({volume.nbytes / 2**20:.0f} MiB; 3-degree rotation, a 5^3 elastic field, J blur"
        f" sigma {LARGE_SIGMA}): read {t1 - t0:.3f} s, compute {t2 - t1:.3f} s, write"
        f" {t3 - t2:.3f} s (the same calls one by one), the entry point {t4 - t3:.3f} s; max abs"
        f" {err:.3g} against resample_fused + gaussian_blur along J; card: {smi}"
    )


def counter_base(torch, tr, tk):
    """The counter base on the card: each rank's rows of a (2, 2) and a
    (4, 1) layout drawn with ``start`` bit-equal to the slice of the
    whole draw (and a base past 2^32 to the plain words); the kernel's
    contiguous draw at start = 0 timed against the parent's kernel (a
    base, no strided segments)."""
    import ctypes

    dev = torch.device(DEVICE)
    key = tr.draw_key(2024, 1)
    shape = (B, C, S, S, S)
    n = math.prod(shape)
    per_row = n // B
    whole = tk.threefry_normal_cuda(key, shape, dev)
    checked = 0
    for data, space in COUNTER_LAYOUTS:
        bl = B // data
        for rank in range(data * space):
            b0 = (rank // space) * bl
            rows = tr.normals([key], [(bl, *shape[1:])], None, dev, starts=[b0 * per_row])
            if not torch.equal(rows.reshape(bl, *shape[1:]), whole[b0:b0 + bl]):
                fail(f"counter base: rank {rank} of ({data}, {space}) differs from its rows")
            checked += 1
    wide = 2**32 - 6
    words = tk.threefry_segments_cuda([key], [4099], None, dev, normal=False, starts=[wide])
    plain = tr.bits_plain(key, wide, 4099, dev)
    if not torch.equal(words.to(torch.int64) & tr.MASK32, plain):
        fail("counter base: words from a base past 2^32 differ from the plain words")
    lib, Row = parent_threefry()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    (segment,) = tk.segment_plan([key], [n], None)[0]
    row = (Row * 1)()
    row[0].k0, row[0].k1 = segment.key
    row[0].inject[:] = segment.inject
    row[0].offset, row[0].count, row[0].start, row[0].scale = 0, n, 0, 1.0

    def parent():
        err = lib.tio_threefry_segments(out.data_ptr(), ctypes.addressof(row), 1, 1,
                                        torch.cuda.current_stream(dev).cuda_stream)
        if err:
            fail(f"the parent threefry kernel failed to launch ({err})")

    parent()
    torch.cuda.synchronize()
    if not torch.equal(out.reshape(shape), whole):
        fail("counter base: the kernel at start = 0 differs from the parent kernel")
    order, ms, parent_ms = time_pair(
        torch, lambda: tk.threefry_normal_cuda(key, shape, dev), parent, 20, 20
    )
    print(
        f"counter base: {checked} ranks' rows of a B={B} x {S}^3 draw equal to the whole draw's,"
        f" words from counter 2^32 - 6 equal to the plain words; the kernel at start = 0"
        f" {ms:.4f} ms, the parent kernel {parent_ms:.4f} ms (new, parent, new, parent:"
        f" {', '.join(f'{t:.4f}' for t in order)}), ratio {ms / parent_ms:.4f}"
    )
    return {"ranks_checked": checked, "ms": ms, "parent_ms": parent_ms,
            "ratio": ms / parent_ms}


def strided_cases(tr, tk):
    """(name, keys, shapes of the whole draws, regions (b0, bl, j0, jl),
    bases, scales) of the strided-segment checks: a run that is a
    multiple of 4 (the headline's J half slab) and runs that are not, a
    base past 2^32, and a full table (MAX_SEGMENTS strided segments in
    one launch)."""
    many = tr.split(tr.prng_key(11), tk.MAX_SEGMENTS)
    table = [(2, 3, 5 + i % 7, 17 + i, 3 + i % 5) for i in range(len(many))]
    return (
        (f"J half slab of B={B} x {S}^3", [tr.draw_key(2024, 1)], [(B, C, S, S, S)],
         [(0, B, S // 2, S // 2)], [0], None),
        ("runs of 91 (b0 = 1)", [tr.prng_key(3)], [(3, 2, 5, 37, 7)], [(1, 2, 11, 13)], [0],
         [0.75]),
        ("runs of 561 past 2^32", [tr.prng_key(4)], [(2, 1, 64, 40, 33)], [(0, 2, 10, 17)],
         [2**32 - 5000], None),
        (f"full table of {len(many)}", many, table,
         [(1, 1, i % 3, 1 + i % 11) for i in range(len(many))],
         [(2**32 - 3000) * (i % 2) for i in range(len(many))],
         [float(i - 19) / 8 for i in range(len(many))]),
    )


def strided_segments(torch, tr, tk, kl, smi):
    """The strided segment on the card: each region's words equal to the
    plain version's, its normals within NORMAL_ATOL of the plain ones (and
    the half slab bit-equal to the same elements of the kernel's whole
    draw), one launch a table; then the headline's Noise draw timed
    contiguous, as a J half slab and as a J quarter slab."""
    dev = torch.device(DEVICE)
    worst, lines = 0.0, []
    for name, keys, shapes, regions, bases, scales in strided_cases(tr, tk):
        spans = [tr.slab_span(shape, *region) for shape, region in zip(shapes, regions)]
        starts = [base + span[0] for base, span in zip(bases, spans)]
        counts = [span[1] for span in spans]
        runs = [span[2] for span in spans]
        pitches = [span[3] for span in spans]
        before = kl.LAUNCHES["threefry_bits"], kl.LAUNCHES["threefry_normal"]
        words = tk.threefry_segments_cuda(keys, counts, None, dev, normal=False, starts=starts,
                                          runs=runs, pitches=pitches)
        got = tk.threefry_segments_cuda(keys, counts, scales, dev, starts=starts, runs=runs,
                                        pitches=pitches)
        grown = kl.LAUNCHES["threefry_bits"] - before[0], kl.LAUNCHES["threefry_normal"] - before[1]
        if grown != (1, 1):
            fail(f"strided segments {name}: launches {grown}, expected one of each")
        offset, err = 0, 0.0
        for s, key in enumerate(keys):
            piece = slice(offset, offset + counts[s])
            plain = tr.bits_plain(key, starts[s], counts[s], dev, runs[s], pitches[s])
            if not torch.equal(words[piece], tr.as_uint32(plain).view(torch.int32)):
                fail(f"strided segments {name}: segment {s}'s words differ from the plain words")
            normal = tr.normal_of_bits(plain)
            if scales is not None:
                normal = normal * torch.tensor(scales[s], dtype=torch.float32, device=dev)
            err = max(err, float((got[piece] - normal).abs().max()))
            offset += counts[s]
            del plain, normal
        if not err <= NORMAL_ATOL:
            fail(f"strided segments {name}: normals max abs {err}")
        if len(keys) == 1 and bases[0] == 0 and scales is None:
            whole = tk.threefry_normal_cuda(keys[0], shapes[0], dev)
            b0, bl, j0, jl = regions[0]
            slab = whole[b0:b0 + bl, :, :, j0:j0 + jl]
            if not torch.equal(got.reshape(slab.shape), slab):
                fail(f"strided segments {name}: not the whole draw's slab")
            del whole, slab
        worst = max(worst, err)
        lines.append(f"{name} ({sum(counts):,} elements, runs % 4 = {sorted({r % 4 for r in runs})})")
        del words, got
    torch.cuda.empty_cache()
    key = tr.draw_key(2024, 1)
    shape = (B, C, S, S, S)
    times = {}
    for parts in (1, 2, 4):
        start, count, run, pitch = tr.slab_span(shape, 0, B, S // parts, S // parts)
        if parts == 1:
            start, count, run, pitch = 0, math.prod(shape), math.prod(shape), math.prod(shape)

        def draw(start=start, count=count, run=run, pitch=pitch):
            return tk.threefry_segments_cuda([key], [count], None, dev, starts=[start],
                                             runs=[run], pitches=[pitch])

        ms = cuda_time_ms(torch, draw, 20)
        times[parts] = {"elements": count, "ms": ms, "ns_per_element": ms * 1e6 / count}
    # the contiguous draw beside a strided segment of 4 elements: the launch
    # runs the strided instantiation, whose loop takes a one-run segment
    # behind a uniform branch (what one instantiation for both would cost)
    n = math.prod(shape)

    def contiguous():
        return tk.threefry_segments_cuda([key], [n], None, dev)

    def beside_strided():
        return tk.threefry_segments_cuda([key, key], [n, 4], None, dev, starts=[0, 0],
                                         runs=[n, 2], pitches=[n, 4])

    if not torch.equal(beside_strided()[:n], contiguous()):
        fail("strided segments: the contiguous draw differs beside a strided segment")
    order, own_ms, shared_ms = time_pair(torch, contiguous, beside_strided, 20, 20)
    print(
        f"strided segments vs plain: {'; '.join(lines)}: words equal, normals max abs"
        f" {worst:.3g} (limit {NORMAL_ATOL}), the half slab equal to the whole draw's; the"
        f" headline's Noise draw (B={B} x {S}^3 normals, CUDA events, 20 launches):"
        f" contiguous {times[1]['ms']:.4f} ms, a J half slab (rank 1 of (1, 2))"
        f" {times[2]['ms']:.4f} ms, a J quarter slab (rank 1 of (1, 4)) {times[4]['ms']:.4f} ms;"
        f" ns an element {times[1]['ns_per_element']:.4f}, {times[2]['ns_per_element']:.4f},"
        f" {times[4]['ns_per_element']:.4f}; the contiguous draw in its own instantiation"
        f" {own_ms:.4f} ms, in the strided one (beside 4 strided elements) {shared_ms:.4f} ms"
        f" (own, strided, own, strided: {', '.join(f'{t:.4f}' for t in order)}), ratio"
        f" {shared_ms / own_ms:.4f}; card: {smi}"
    )
    return {"max_abs_err": worst, "draws": {f"1/{k}": v for k, v in times.items()},
            "contiguous_in_strided_ratio": shared_ms / own_ms}


def parallel_pipelines(torch, tio, kl, mesh, smi):
    """config 1 (Flip + Noise + RescaleIntensity, fused), config 2 (Blur +
    BiasField + Gamma) and brats-preprocess-fused (Clamp + ZNormalization +
    Mask) on ``shard_(mesh, spatial=True)``: no gather in the call, the
    output still on the mesh, equal to the unsharded call on the same
    seed (config 2's Blur takes halo taps along J: within PARALLEL_ATOL)."""
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    dev = torch.device(DEVICE)
    report = {}
    cases = (
        ("config1-flip-noise-rescale", config1_pipeline,
         lambda: make_batch(tio, torch, B, CONFIG1_SHAPE, dev, 1), 0.0),
        ("config2-blur-bias-gamma", config2_pipeline,
         lambda: make_batch(tio, torch, B, (S, S, S), dev, 2), PARALLEL_ATOL),
        ("brats-preprocess-fused", brats_preprocess,
         lambda: make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0), 0.0),
    )
    for name, make_pipeline, make, atol in cases:
        batch = make()
        tio.seed(PARALLEL_SEED)
        ref = make_pipeline(tio)(copy.deepcopy(batch))
        sharded = copy.deepcopy(batch).shard_(mesh, spatial=True)
        tio.seed(PARALLEL_SEED)
        with GatherSpy(torch, tio) as spy:
            out = make_pipeline(tio)(sharded)
            torch.cuda.synchronize()
        if spy.gathers:
            fail(f"parallel {name}: gathers in the sharded call {spy.gathers}")
        errs = {}
        for image, ib in out.images.items():
            if not is_dtensor(ib.data) or ib.sharding is None:
                fail(f"parallel {name}: {image} is not on the mesh after the call")
            got = ib.data.full_tensor()
            want = ref.images[image].data
            errs[image] = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
            if not errs[image] <= atol:
                fail(f"parallel {name}: {image} max abs {errs[image]} against the unsharded call")
        if [t.name for t in out.applied_transforms] != [t.name for t in ref.applied_transforms]:
            fail(f"parallel {name}: histories differ")
        report[name] = errs
        del batch, ref, sharded, out
        torch.cuda.empty_cache()
    print(
        f"parallel pipelines on shard_(mesh (1, 1), spatial=True): no gather in any call;"
        f" max abs against the unsharded call {report}; card: {smi}"
    )
    return report


#: the sharded label and index pipelines: RemapLabels' 32 labels
#: to 8 classes, the seed, the index pipeline's pad and resize, and the
#: collective-free stages' crop along I and K (as processes sharing the card)
LABEL_CLASSES = 8
LABEL_SEED = 7
INDEX_PAD, INDEX_RESIZE = 2, (160, 160, 128)
FREE_CROP = (224, SYNTH_SHAPE[1], 240)
LABEL_REPS = 3
#: launches a call of the sharded cells: the grid-spec resample of ixi's
#: Resample on each rank's columns (t1 and seg); config 4's halo programs
#: (ElasticDeformation and its inverse, each of t1 and seg)
IXI_COLUMN_LAUNCHES, CONFIG4_HALO_LAUNCHES = 2, 4


def label_classes():
    """RemapLabels' map of synthseg's labels to LABEL_CLASSES classes."""
    per_class = SYNTH_LABELS // LABEL_CLASSES
    return {label: label // per_class for label in range(SYNTH_LABELS)}


def labels_pipeline(tio):
    """synthseg's label map through the label stages: geometry, labels to
    classes, a class removed, thick slices, compacted labels, contours,
    one-hot."""
    return tio.Compose([
        tio.Spatial(scales=(0.9, 1.1), degrees=10, max_displacement=7.5),
        tio.RemapLabels(label_classes()),
        tio.RemoveLabels([7]),
        tio.Anisotropy(downsampling=(1.5, 5)),
        tio.SequentialLabels(),
        tio.Contour(),
        tio.OneHot(),
    ])


def index_pipeline(tio, orientation):
    """ixi's subjects through the index stages: reorient, crop or pad to
    ixi's crop, a reflect pad and its crop, resize, patch swaps, PCA (one
    component: one channel), one-hot labels."""
    return tio.Compose([
        tio.Reorient(orientation),
        tio.CropOrPad(IXI_CROP),
        tio.Pad(padding=INDEX_PAD, padding_mode="reflect"),
        tio.Crop(cropping=INDEX_PAD),
        tio.Resize(INDEX_RESIZE),
        tio.Swap(patch_size=15, num_iterations=100),
        tio.PCA(num_components=1),
        tio.OneHot(),
    ])


def timed_call(torch, tio, call, make_batch, reps=LABEL_REPS):
    """The median of ``reps`` calls of ``call`` (a fresh pipeline's call)
    on a fresh batch (host clock, synchronised), the seed set before each;
    the largest peak of the card's memory in a call and the bytes resident
    before it (the input batch)."""
    runs, peaks = [], []
    for _ in range(reps):
        batch = make_batch()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tio.seed(LABEL_SEED)
        t0 = time.perf_counter()
        call(batch)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        del batch
    return statistics.median(runs), max(peaks), resident


def peak_call(torch, tio, pipeline, batch):
    """``pipeline(batch)`` from LABEL_SEED with the card's resident bytes
    before it and its peak."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tio.seed(LABEL_SEED)
    out = pipeline(batch)
    torch.cuda.synchronize()
    return out, resident, torch.cuda.max_memory_allocated()


def spatial_ties(torch, np, rs, batch):
    """(B, 1, *shape) True where the nearest labels of a batch's first
    record, a Spatial on its own space, may differ between the halo
    program and the grid-spec kernel: a coordinate within TIE_BAND of a
    .5 tie."""
    ib = batch.seg
    shape = tuple(ib.data.shape[2:])
    maps, fields = slice_grids(np, rs, batch.applied_transforms[0].params, ib.affines[0],
                               shape, ib.data.device)
    return ~coord_tie_mask(torch, rs, maps, fields, shape)


def compare_outputs(torch, tio, name, out, want, ties=None, atol=PARALLEL_ATOL):
    """Each image of ``out`` (a DTensor on the mesh) against ``want``'s:
    label maps bit for bit (off ``ties``), images within ``atol``; the
    differing voxels or max abs of each."""
    from torchio_tpu_torch.parallel.mesh import is_dtensor

    errs = {}
    for image, ib in out.images.items():
        data = ib.data
        if not is_dtensor(data) or ib.sharding is None:
            fail(f"parallel {name}: {image} is not a DTensor on the mesh ({type(data)})")
        got, ref = data.full_tensor(), want.images[image].data
        if got.shape != ref.shape or got.dtype != ref.dtype:
            fail(f"parallel {name}: {image} {tuple(got.shape)} {got.dtype} against"
                 f" {tuple(ref.shape)} {ref.dtype}")
        if issubclass(ib.image_class, tio.LabelMap):
            differ = got != ref
            errs[image] = int(differ.sum())
            off_ties = int((differ & ~ties).sum()) if ties is not None else errs[image]
            if off_ties:
                fail(f"parallel {name}: {image} differs from the unsharded call at"
                     f" {off_ties} voxels" + (" off near ties" if ties is not None else ""))
        else:
            errs[image] = float((got.double() - ref.double()).abs().max())
            if not errs[image] <= atol:
                fail(f"parallel {name}: {image} max abs {errs[image]} against the unsharded call")
    if [t.name for t in out.applied_transforms] != [t.name for t in want.applied_transforms]:
        fail(f"parallel {name}: histories differ")
    return errs


def sharded_stages(torch, np, tio, kl, mesh, smi, name, make_pipeline, make_batch, spatial,
                   lead=0, launches=None, inverse=False, rest_ties=None, exact=False):
    """One pipeline on ``shard_(mesh, spatial=...)`` (then, with
    ``inverse``, ``apply_inverse_transform()`` of its result): no gather
    and no stage in ``gathered`` in the call, each output a DTensor on the
    mesh, the same history as the unsharded call on the same seed. Its
    first ``lead`` stages (a Spatial) run the halo program, whose nearest
    labels may differ from the grid-spec kernel's at near ties: their
    output is held to the unsharded call off near ties
    (:func:`spatial_ties`), and the later stages to the unsharded stages
    on that same output (label maps bit for bit, off ``rest_ties(batch,
    lead output)`` where given: an inverse that resamples too; images
    within PARALLEL_ATOL, bit for bit where ``exact``). The sharded call
    launches the kernels ``launches`` names (a dict, or a function of the
    sharded output that gives it), as often, and no other. The median
    call times and the peaks of both."""
    rs = importlib.import_module("torchio_tpu_torch.ops.resample")
    t0 = time.perf_counter()
    batch = make_batch()
    stages = make_pipeline(tio).transforms
    first, rest = tio.Compose(stages[:lead]), tio.Compose(stages[lead:])

    def after(b):
        out = rest(b)
        return out.apply_inverse_transform() if inverse else out

    sharded = copy.deepcopy(batch).shard_(mesh, spatial=spatial)
    kl.reset_launches()
    with GatherSpy(torch, tio, stages) as spy:
        tio.seed(LABEL_SEED)
        led = first(sharded)
        out = after(led)
        torch.cuda.synchronize()
    launched = {kernel: n for kernel, n in kl.LAUNCHES.items() if n}
    expected = (launches(out) if callable(launches) else launches) or {}
    if launched != expected:
        fail(f"parallel {name}: launches {launched}, expected {expected}")
    if spy.gathers or spy.entered:
        fail(f"parallel {name}: gathers {spy.gathers}, stages in gathered {spy.entered}")
    tio.seed(LABEL_SEED)
    ref = after(first(copy.deepcopy(batch)))
    errs = {}
    atol = 0.0 if exact else PARALLEL_ATOL
    if lead:
        # the lead against the unsharded lead off near ties; the rest
        # against the unsharded stages on the lead's own output
        tio.seed(LABEL_SEED)
        ref_led = first(copy.deepcopy(batch))
        errs["lead"] = compare_outputs(torch, tio, f"{name} (lead)", led, ref_led,
                                       spatial_ties(torch, np, rs, ref_led))
        del ref_led
        errs["whole"] = {
            image: int((ib.data.full_tensor() != ref.images[image].data).sum())
            for image, ib in out.images.items() if issubclass(ib.image_class, tio.LabelMap)
        }
        same_lead = copy.deepcopy(led).unshard_()
        del ref
        ref = after(same_lead)
        errs["output"] = compare_outputs(torch, tio, name, out, ref,
                                         rest_ties and rest_ties(batch, same_lead), atol)
    else:
        errs["output"] = compare_outputs(torch, tio, name, out, ref, None, atol)
    shapes = {image: list(ib.data.shape) for image, ib in out.images.items()}
    del ref, out, led, sharded
    torch.cuda.empty_cache()
    sharded_ms, peak, resident = timed_call(
        torch, tio, lambda b: after(first(b)),
        lambda: copy.deepcopy(batch).shard_(mesh, spatial=spatial))
    whole_ms, whole_peak, whole_resident = timed_call(
        torch, tio, lambda b: after(first(b)), lambda: copy.deepcopy(batch))
    times = {"sharded": sharded_ms, "unsharded": whole_ms}
    del batch
    torch.cuda.empty_cache()
    mib = 2**20
    seconds = time.perf_counter() - t0
    print(
        f"parallel {name} on shard_(mesh (1, 1), spatial={spatial}): outputs {shapes}, launches"
        f" {launched}, no gather and no stage in gathered; against the unsharded call {errs} (labels: differing"
        f" voxels; images: max abs; 'lead': the halo program against the grid-spec kernel, differing"
        f" only at near ties; 'whole': the pipeline's labels against the unsharded pipeline's;"
        f" 'output': the stages after the lead against the unsharded stages on the same input);"
        f" a call {times['sharded'] * 1e3:.1f} ms sharded, {times['unsharded'] * 1e3:.1f} ms"
        f" unsharded (median of {LABEL_REPS}, host clock); peak {(peak - resident) / mib:.0f} MiB"
        f" over the input on the shard (resident {resident / mib:.0f} MiB),"
        f" {(whole_peak - whole_resident) / mib:.0f} MiB unsharded (resident"
        f" {whole_resident / mib:.0f} MiB); {seconds:.1f} s; card: {smi}"
    )
    return {"errors": errs, "launches": launched, "ms": {k: v * 1e3 for k, v in times.items()},
            "peak_over_input_mib": (peak - resident) / mib,
            "unsharded_peak_over_input_mib": (whole_peak - whole_resident) / mib, "s": seconds}


def parallel_label_pipelines(torch, np, tio, kl, mesh, smi):
    """The labels pipeline on synthseg's label maps (B and J sharded: one
    ``resample_coords`` launch a call, Spatial's halo program on the label
    map) and the index pipeline on ixi's subjects (B sharded with
    Reorient("RAS"), which moves J; B and J sharded with Reorient("PRI"),
    which flips J; no kernel)."""
    dev = torch.device(DEVICE)
    report = {}
    cases = (
        ("labels", labels_pipeline,
         lambda: make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev), True, 1,
         {"resample_coords": 1}),
        ("index-RAS", lambda t: index_pipeline(t, "RAS"),
         lambda: make_ixi_batch(tio, torch, np, IXI_B, IXI_SHAPE, dev, IXI_SEED), False, 0,
         None),
        ("index-PRI", lambda t: index_pipeline(t, "PRI"),
         lambda: make_ixi_batch(tio, torch, np, IXI_B, IXI_SHAPE, dev, IXI_SEED), True, 0,
         None),
    )
    for name, make_pipeline, make, spatial, lead, launches in cases:
        report[name] = sharded_stages(torch, np, tio, kl, mesh, smi, name, make_pipeline, make,
                                      spatial, lead, launches)
    return report


def inverse_ties(torch, np, rs, tio, batch, led):
    """(B, 1, *shape) True where the nearest labels of the inverse of
    ``led``'s first record (config 4's ElasticDeformation) may differ
    between the halo program and the grid-spec kernel."""
    seg = led.seg.data
    shape = tuple(seg.shape[2:])
    maps, fields = inverse_grids(np, rs, tio, led.applied_transforms[0].params,
                                 batch.seg.affines[0], shape, seg.device)
    return ~coord_tie_mask(torch, rs, maps, fields, shape)


def kspace_launches(out):
    """One dense resample launch where Motion kept an element (its
    record), none where it gated out every element."""
    return {"resample_coords": 1} if any(
        t.name == "Motion" for t in out.applied_transforms) else {}


def parallel_gather_free_cells(torch, np, tio, kl, mesh, smi):
    """The cells whose last stages used to gather, whole at full
    width on ``shard_(mesh, spatial=True)``: synthseg-labels-to-image
    (Spatial's halo program on the label maps, then LabelsToImage's 32
    labels drawn on the region), ixi-preprocess-histstd from "PLI"
    (Reorient("RAS") moves J; Resample on each rank's output columns; the
    histogram's quantiles; bit for bit), kspace-motion-ghosting (also on
    ``shard_(mesh)``, a B split; bit for bit) and config4-elastic-inverse
    (the halo program forward and in the inverse, whose t1 is held within
    PARALLEL_ATOL, its labels off the inverse's near ties): no gather, no
    stage in ``gathered``."""
    rs = importlib.import_module("torchio_tpu_torch.ops.resample")
    dev = torch.device(DEVICE)
    landmarks = ixi_landmarks(tio, torch, IXI_SHAPE, dev, IXI_SEED)
    cases = {
        "synthseg-labels-to-image": dict(
            make_pipeline=synthseg_pipeline, lead=1,
            make_batch=lambda: make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev),
            launches=lambda out: {"resample_coords": 1,
                                  "threefry_normal": synth_launches(out.applied_transforms)}),
        "ixi-preprocess-histstd": dict(
            make_pipeline=lambda t: ixi_pipeline(t, landmarks, IXI_CROP),
            make_batch=lambda: make_ixi_batch(tio, torch, np, IXI_B, IXI_SHAPE, dev, IXI_SEED),
            launches={"resample": IXI_COLUMN_LAUNCHES}),
        "kspace-motion-ghosting": dict(
            make_pipeline=kspace_pipeline, launches=kspace_launches,
            make_batch=lambda: make_kspace_batch(tio, torch, B, (S, S, S), dev, 0)),
        "kspace-motion-ghosting (B split)": dict(
            make_pipeline=kspace_pipeline, launches=kspace_launches, spatial=False,
            make_batch=lambda: make_kspace_batch(tio, torch, B, (S, S, S), dev, 0)),
        "config4-elastic-inverse": dict(
            make_pipeline=config4_forward, lead=1, inverse=True,
            make_batch=lambda: make_suite_batch(tio, torch, B, {"t1": 1}, (S, S, S), (1, 1, 1),
                                                dev, 4),
            launches={"resample_coords": CONFIG4_HALO_LAUNCHES}, exact=False,
            rest_ties=lambda batch, led: inverse_ties(torch, np, rs, tio, batch, led)),
    }
    report = {}
    for name, case in cases.items():
        case.setdefault("exact", True)
        report[name] = sharded_stages(torch, np, tio, kl, mesh, smi, name,
                                      case.pop("make_pipeline"), case.pop("make_batch"),
                                      case.pop("spatial", True), **case)
    return report


def collective_free(tio):
    """The label stages that need no collective on any layout: labels to
    classes, a class removed, a crop along I and K, a one-hot of a fixed
    class count."""
    return tio.Compose([
        tio.RemapLabels(label_classes()),
        tio.RemoveLabels([7]),
        tio.CropOrPad(FREE_CROP),
        tio.OneHot(num_classes=LABEL_CLASSES),
    ])


def label_shard_worker(rank: int, world: int, port: int, space: int) -> None:
    """One of ``world`` processes sharing the card in a gloo group:
    :func:`collective_free` on its block of synthseg's label maps at the
    layout (world / space, space), against its block of the unsharded
    call; prints one JSON line."""
    import json as json_mod

    import torch
    import torch.distributed as dist

    import torchio_tpu_torch as tio
    from torchio_tpu_torch.parallel import make_mesh
    from torchio_tpu_torch.parallel.mesh import shard_range

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        dev = torch.device(DEVICE)
        mesh = make_mesh(DEVICE, space=space)
        data, column = mesh.get_coordinate()
        batch = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev)
        tio.seed(LABEL_SEED)
        ref = collective_free(tio)(copy.deepcopy(batch)).seg.data
        rows = slice(*shard_range(ref.shape[0], world // space, data))
        cols = slice(*shard_range(ref.shape[3], space, column))
        want = ref[rows][:, :, :, cols].cpu()  # off the card: not in the peak
        del ref
        batch.shard_(mesh, spatial=space > 1)
        out, resident, peak = peak_call(torch, tio, collective_free(tio), batch)
        local = out.seg.data.to_local()
        print(json_mod.dumps({
            "rank": rank, "equal": bool(torch.equal(local.cpu(), want)),
            "local_shape": list(local.shape), "resident": resident, "peak": peak,
        }))
    finally:
        dist.destroy_process_group()


#: the layouts of the collective-free label stages as processes sharing
#: the card: (world, space)
LABEL_PROCESS_LAYOUTS = ((2, 1), (2, 2), (4, 4))


def simulated_collective_free(torch, tio, world, space, ref):
    """Each shard's local program of :func:`collective_free` (its block as
    a batch of its own: the stages make no collective), against its block
    of the unsharded call, with its peak memory."""
    from torchio_tpu_torch.parallel.mesh import shard_range

    dev = torch.device(DEVICE)
    report = []
    seg = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev).seg.data
    for rank in range(world):
        rows = slice(*shard_range(SYNTH_B, world // space, rank // space))
        cols = slice(*shard_range(SYNTH_SHAPE[1], space, rank % space))
        block = seg[rows][:, :, :, cols]
        batch = tio.SubjectsBatch.from_subjects(
            [tio.Subject(seg=tio.LabelMap(e.clone())) for e in block])
        out, resident, peak = peak_call(torch, tio, collective_free(tio), batch)
        equal = torch.equal(out.seg.data, ref[rows][:, :, :, cols])
        report.append({"rank": rank, "equal": bool(equal), "local_shape": list(out.seg.data.shape),
                       "resident": resident, "peak": peak})
        del batch, out
    return report


def parallel_label_processes(torch, tio, smi):
    """:func:`collective_free` on each block of (2, 1), (1, 2) and (1, 4),
    as 2 and 4 processes sharing the card in a gloo group (where gloo
    refuses a CUDA tensor, each shard's local program in this process),
    each block bit-equal to the unsharded call's, with its peak memory."""
    dev = torch.device(DEVICE)
    batch = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev)
    out, resident, whole_peak = peak_call(torch, tio, collective_free(tio), batch)
    ref = out.seg.data
    report = {"unsharded": {"resident": resident, "peak": whole_peak}}
    for world, space in LABEL_PROCESS_LAYOUTS:
        layout = f"({world // space}, {space})"
        results, errors = shard_processes(world, worker="label_shard_worker",
                                          extra=f", {space}")
        route = "processes"
        if errors or len(results) != world:
            refusals = [m for e in errors for m in re.findall(f".*(?:{GLOO_REFUSES_CUDA}).*", e)]
            if not refusals:
                fail(f"the collective-free label stages as {world} processes at {layout}:"
                     f" {len(results)} of {world} gave a result; their errors:\n"
                     + "\n---\n".join(errors))
            route = f"simulated (gloo refused a CUDA tensor: {refusals[0].strip()})"
            results = simulated_collective_free(torch, tio, world, space, ref)
        bad = [r["rank"] for r in results if not r["equal"]]
        if bad:
            fail(f"the collective-free label stages on {layout} ({route}): blocks {bad} differ")
        report[layout] = {"route": route, "shards": results}
    del batch, out, ref
    torch.cuda.empty_cache()
    mib = 2**20
    print(
        "RemapLabels + RemoveLabels + CropOrPad (I and K) + OneHot(num_classes=8) on each block"
        f" of synthseg's B={SYNTH_B} x {SYNTH_SHAPE[0]}^3 labels (equal to the unsharded call's"
        f" block): unsharded peak {whole_peak / mib:.0f} MiB (resident {resident / mib:.0f}"
        " MiB); " + "; ".join(
            f"{layout} by {entry['route']}: peaks "
            f"{[round(r['peak'] / mib) for r in entry['shards']]} MiB (resident "
            f"{[round(r['resident'] / mib) for r in entry['shards']]} MiB)"
            for layout, entry in report.items() if layout != "unsharded"
        ) + f"; card: {smi}"
    )
    return report


def inverse_forward(tio):
    """Pointwise stages whose recorded inverses need no collective on any
    layout (the rescale's, the standardisation's, the bias field's, the
    gamma's, the one-hot's)."""
    return tio.Compose([
        tio.RescaleIntensity(out_min=(0.0, 0.2), out_max=1.0),
        tio.ZNormalization(),
        tio.BiasField(std=0.3),
        tio.Gamma(log_gamma=(-0.3, 0.3)),
        tio.OneHot(),
    ])


def free_parts(torch, tio, mesh, world, space, dev):
    """The collective-free parts on this rank's block at (world / space,
    space), each against its block of the unsharded call, with the bytes
    resident before its sharded call and its peak: LabelsToImage given the
    unsharded call's label set and draws (synthseg's label maps), the
    recorded pointwise inverses (:func:`inverse_forward`'s history on the
    k-space batch) and, where J is whole, Motion + Ghosting."""
    from torchio_tpu_torch.parallel.mesh import shard_range

    data, column = mesh.get_coordinate()

    def block(x):
        rows = slice(*shard_range(x.shape[0], world // space, data))
        cols = slice(*shard_range(x.shape[3], space, column))
        return x[rows][:, :, :, cols].cpu()  # off the card: not in the peak

    def entry(out, want, resident, peak):
        local = {n: ib.data.to_local() for n, ib in out.images.items() if n in want}
        return {"equal": all(torch.equal(local[n].cpu(), w) for n, w in want.items()),
                "local_shape": list(next(iter(local.values())).shape),
                "resident": resident, "peak": peak}

    report = {}
    batch = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev)
    stage = tio.LabelsToImage(label_key="seg")
    tio.seed(LABEL_SEED)
    params = stage.make_params(batch)
    want = {"image_from_labels": block(
        stage.apply_transform(copy.deepcopy(batch), params).image_from_labels.data)}
    batch.shard_(mesh, spatial=space > 1)
    out, resident, peak = peak_call(torch, tio, lambda b: stage.apply_transform(b, params), batch)
    report["labels-to-image"] = entry(out, want, resident, peak)
    del batch, out, want
    batch = make_kspace_batch(tio, torch, B, (S, S, S), dev, 0)
    tio.seed(LABEL_SEED)
    forward = inverse_forward(tio)(batch)
    ref = forward.apply_inverse_transform()
    want = {n: block(ib.data) for n, ib in ref.images.items()}
    del ref
    sharded = copy.deepcopy(forward).shard_(mesh, spatial=space > 1)
    del forward
    out, resident, peak = peak_call(torch, tio, lambda b: b.apply_inverse_transform(), sharded)
    report["pointwise-inverses"] = entry(out, want, resident, peak)
    del sharded, out
    if space == 1:
        tio.seed(LABEL_SEED)
        want = {"t1": block(kspace_pipeline(tio)(copy.deepcopy(batch)).t1.data)}
        batch.shard_(mesh)
        out, resident, peak = peak_call(torch, tio, kspace_pipeline(tio), batch)
        report["kspace"] = entry(out, want, resident, peak)
        del out
    del batch
    torch.cuda.empty_cache()
    return report


def free_shard_worker(rank: int, world: int, port: int, space: int) -> None:
    """One of ``world`` processes sharing the card in a gloo group:
    :func:`free_parts` at the layout (world / space, space); prints one
    JSON line."""
    import json as json_mod

    import torch
    import torch.distributed as dist

    import torchio_tpu_torch as tio
    from torchio_tpu_torch.parallel import make_mesh

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(DEVICE, space=space)
        parts = free_parts(torch, tio, mesh, world, space, torch.device(DEVICE))
        print(json_mod.dumps({"rank": rank, "parts": parts}))
    finally:
        dist.destroy_process_group()


def parallel_free_processes(torch, tio, smi):
    """:func:`free_parts` on each block of (2, 1), (1, 2) and (1, 4) as 2
    and 4 processes sharing the card in a gloo group (k-space at (2, 1)
    only: a J split gathers its rows), every block bit-equal to the
    unsharded call's, with each part's peak over its input; the unsharded
    calls' peaks over their input beside them."""
    dev = torch.device(DEVICE)
    unsharded = {}
    batch = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev)
    stage = tio.LabelsToImage(label_key="seg")
    tio.seed(LABEL_SEED)
    params = stage.make_params(batch)
    _, resident, peak = peak_call(torch, tio, lambda b: stage.apply_transform(b, params), batch)
    unsharded["labels-to-image"] = peak - resident
    batch = make_kspace_batch(tio, torch, B, (S, S, S), dev, 0)
    tio.seed(LABEL_SEED)
    forward = inverse_forward(tio)(copy.deepcopy(batch))
    _, resident, peak = peak_call(torch, tio, lambda b: b.apply_inverse_transform(), forward)
    unsharded["pointwise-inverses"] = peak - resident
    del forward
    _, resident, peak = peak_call(torch, tio, kspace_pipeline(tio), batch)
    unsharded["kspace"] = peak - resident
    del batch, stage
    torch.cuda.empty_cache()
    report = {}
    for world, space in LABEL_PROCESS_LAYOUTS:
        layout = f"({world // space}, {space})"
        results, errors = shard_processes(world, worker="free_shard_worker", extra=f", {space}")
        if errors or len(results) != world:
            fail(f"the collective-free parts as {world} processes at {layout}: {len(results)}"
                 f" of {world} gave a result; their errors:\n" + "\n---\n".join(errors))
        bad = [(r["rank"], part) for r in results for part, e in r["parts"].items()
               if not e["equal"]]
        if bad:
            fail(f"the collective-free parts on {layout}: blocks {bad} differ")
        report[layout] = results
    mib = 2**20
    peaks = {
        layout: {part: [round((r["parts"][part]["peak"] - r["parts"][part]["resident"]) / mib)
                        for r in results] for part in results[0]["parts"]}
        for layout, results in report.items()
    }
    print(
        "LabelsToImage given the label set, the recorded pointwise inverses (Rescale,"
        " Standardize, BiasField, Gamma, OneHot) and k-space on a B split, on each block as"
        " processes sharing the card (equal to the unsharded call's block): peaks over the"
        f" input, MiB a process, {peaks}; unsharded"
        f" {({k: round(v / mib) for k, v in unsharded.items()})}; card: {smi}"
    )
    return {"peaks_over_input_mib": peaks,
            "unsharded_mib": {k: v / mib for k, v in unsharded.items()}}


def simulate_label_planes(torch, tio, smi):
    """Contour's and the reflect Pad's J planes as each shard's local
    program of a (1, 2) and a (1, 4) layout, fed the planes its neighbours
    would send (sliced from the global volume: Contour's plane beside each
    end, the reflect pad's columns by ``halo.column_routes``), reassembled
    against the unsharded stage bit for bit."""
    import numpy as np

    from torchio_tpu_torch.parallel import halo as halo_mod
    from torchio_tpu_torch.parallel.mesh import shard_range
    from torchio_tpu_torch.transforms.label.contour import contour_block
    from torchio_tpu_torch.transforms.spatial._padding import _border_index, pad_tensor

    dev = torch.device(DEVICE)
    seg = make_synth_batch(tio, torch, SYNTH_B, SYNTH_SHAPE, dev).seg.data.to(torch.float32)
    contour = tio.Contour()(tio.SubjectsBatch.from_subjects(
        [tio.Subject(seg=tio.LabelMap(e)) for e in seg])).seg.data
    t1 = ixi_volumes(torch, IXI_B, IXI_SHAPE, dev, IXI_SEED)
    ik = (INDEX_PAD, INDEX_PAD, 0, 0, INDEX_PAD, INDEX_PAD)
    padded = pad_tensor(t1, (INDEX_PAD,) * 6, "reflect", 0.0)
    sj, pj = t1.shape[3], padded.shape[3]
    index = _border_index(sj, INDEX_PAD, INDEX_PAD, "reflect", "cpu").numpy()
    report = {}
    for parts in PARALLEL_LAYOUTS:
        ranges = [shard_range(sj, parts, s) for s in range(parts)]
        out_ranges = [shard_range(pj, parts, s) for s in range(parts)]
        needs = [index[a:b] for a, b in out_ranges]
        # each shard's block padded along I and K (its own work), then the
        # J columns its pad reads from itself and the shards that hold them
        blocks = [pad_tensor(t1[:, :, :, a:b], ik, "reflect", 0.0) for a, b in ranges]
        contour_ok, pad_ok = True, True
        for s, (j0, j1) in enumerate(ranges):
            left = seg[:, :, :, j0 - 1:j0] if j0 > 0 else None
            right = seg[:, :, :, j1:j1 + 1] if j1 < sj else None
            got = contour_block(seg[:, :, :, j0:j1], left, right)
            contour_ok &= torch.equal(got, contour[:, :, :, j0:j1])
            _, want, _, takes = halo_mod.column_routes(sj, needs, parts, s)
            pieces = {}
            for p, at in takes.items():
                p0, _, sends, _ = halo_mod.column_routes(sj, needs, parts, p)
                cols = want[at] - p0 if p == s else sends[s] - p0
                pieces[p] = (at, blocks[p].index_select(3, torch.as_tensor(cols, device=dev)))
            assembled = halo_mod.assemble_columns(blocks[s], want, pieces, needs[s])
            a, b = out_ranges[s]
            pad_ok &= torch.equal(assembled, padded[:, :, :, a:b])
        if not (contour_ok and pad_ok):
            fail(f"simulated label planes on (1, {parts}): Contour equal {contour_ok},"
                 f" reflect Pad equal {pad_ok}")
        report[f"(1, {parts})"] = {"contour": bool(contour_ok), "pad_reflect": bool(pad_ok)}
    print(
        f"simulated label planes (each shard's local program fed its neighbours' planes):"
        f" Contour on synthseg's B={SYNTH_B} x {SYNTH_SHAPE[0]}^3 labels and the reflect Pad"
        f" ({INDEX_PAD}) along J on ixi's B={IXI_B} x {IXI_SHAPE} t1, bit-equal to the"
        f" unsharded stage: {report}; card: {smi}"
    )
    del seg, contour, t1, padded, blocks
    torch.cuda.empty_cache()
    return report


#: the C, I and K splits of a sharded batch: the tensor dim each splits
SPLIT_DIMS = {"C": 1, "I": 2, "K": 4}
#: the splits as processes sharing the card: (split, processes, cells);
#: brats-preprocess-fused alone on C (config 1's image has one channel)
SPLIT_PROCESS_RUNS = (("I", 2, ("brats", "config1")), ("K", 4, ("brats", "config1")),
                      ("C", 2, ("brats",)), ("C", 4, ("brats",)))


def split_sharding(mesh, split: str):
    """B over the mesh's first axis and the ``split`` dim (C, I or K) over
    its second."""
    from torchio_tpu_torch.parallel.mesh import NamedSharding

    data, space = mesh.mesh_dim_names
    spec = [data, None, None, None, None]
    spec[SPLIT_DIMS[split]] = space
    return NamedSharding(mesh, tuple(spec))


def launch_counts(kl):
    return {kernel: n for kernel, n in kl.LAUNCHES.items() if n}


def parallel_splits(torch, np, tio, kl, mesh, smi):
    """The headline, brats-preprocess-fused and ixi-preprocess-histstd at
    full width on the one-rank mesh with I split and with K split
    (``SubjectsBatch.shard_(NamedSharding)``): a one-rank axis leaves its
    dim whole, so no stage enters ``gathered`` and nothing is gathered;
    the launches of the unsharded call, and its outputs by
    :func:`compare_outputs` (bit for bit where ``exact``); the median
    call times and peaks over the input of both."""
    dev = torch.device(DEVICE)
    landmarks = ixi_landmarks(tio, torch, IXI_SHAPE, dev, IXI_SEED)
    cases = {
        "headline": (headline, lambda: make_batch(tio, torch, B, (S, S, S), dev, PARALLEL_SEED),
                     False),
        "brats-preprocess-fused": (
            brats_preprocess, lambda: make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0),
            True),
        "ixi-preprocess-histstd": (
            lambda t: ixi_pipeline(t, landmarks, IXI_CROP),
            lambda: make_ixi_batch(tio, torch, np, IXI_B, IXI_SHAPE, dev, IXI_SEED), True),
    }
    report = {}
    mib = 2**20
    for name, (make_pipeline, make_batch_, exact) in cases.items():
        batch = make_batch_()
        kl.reset_launches()
        tio.seed(PARALLEL_SEED)
        ref = make_pipeline(tio)(copy.deepcopy(batch))
        torch.cuda.synchronize()
        want = launch_counts(kl)
        for split in ("I", "K"):
            label = f"{name} ({split} split)"
            sharding = split_sharding(mesh, split)
            sharded = copy.deepcopy(batch).shard_(sharding)
            kl.reset_launches()
            with GatherSpy(torch, tio) as spy:
                tio.seed(PARALLEL_SEED)
                out = make_pipeline(tio)(sharded)
                torch.cuda.synchronize()
            launched = launch_counts(kl)
            if spy.gathers or spy.entered:
                fail(f"parallel {label}: gathers {spy.gathers}, stages in gathered {spy.entered}"
                     " on a one-rank axis")
            if launched != want:
                fail(f"parallel {label}: launches {launched}, the unsharded call's {want}")
            errs = compare_outputs(torch, tio, label, out, ref, None,
                                   0.0 if exact else PARALLEL_ATOL)
            del out, sharded
            torch.cuda.empty_cache()
            sharded_s, peak, resident = timed_call(
                torch, tio, lambda b: make_pipeline(tio)(b),
                lambda: copy.deepcopy(batch).shard_(sharding))
            whole_s, whole_peak, whole_resident = timed_call(
                torch, tio, lambda b: make_pipeline(tio)(b), lambda: copy.deepcopy(batch))
            report[label] = {"errors": errs, "launches": launched,
                             "ms": {"sharded": sharded_s * 1e3, "unsharded": whole_s * 1e3},
                             "peak_over_input_mib": (peak - resident) / mib,
                             "unsharded_peak_over_input_mib": (whole_peak - whole_resident) / mib}
            print(
                f"parallel {label} on shard_(NamedSharding(mesh (1, 1), {sharding.spec})): no"
                f" stage in gathered, no gather (a one-rank axis is whole); launches {launched}"
                f" as unsharded; against the unsharded call {errs}; a call"
                f" {sharded_s * 1e3:.1f} ms sharded, {whole_s * 1e3:.1f} ms unsharded (median of"
                f" {LABEL_REPS}, host clock); peak {(peak - resident) / mib:.0f} MiB over the input"
                f" (resident {resident / mib:.0f} MiB), {(whole_peak - whole_resident) / mib:.0f}"
                f" MiB unsharded; card: {smi}"
            )
        del batch, ref
        torch.cuda.empty_cache()
    return report


def gloo_full_tensor(dtensor):
    """``DTensor.full_tensor`` by ``dist.all_gather`` over the group of each
    mesh axis that shards it (uneven blocks padded to the widest): torch
    2.11's own, through the functional collectives, crashes on a gloo
    group of CUDA tensors, where gloo's c10d all-gathers run
    (``probes/gloo_cuda.py``)."""
    import torch
    import torch.distributed as dist

    from torchio_tpu_torch.parallel.mesh import shard_range

    out = dtensor.to_local()
    mesh = dtensor.device_mesh
    for mesh_dim, placement in enumerate(dtensor.placements):
        if not placement.is_shard():
            continue
        dim, group = placement.dim, mesh.get_group(mesh_dim)
        parts, size = dist.get_world_size(group), int(dtensor.shape[placement.dim])
        widths = [stop - start for start, stop in (shard_range(size, parts, p)
                                                   for p in range(parts))]
        pad = list(out.shape)
        pad[dim] = max(widths) - out.shape[dim]
        padded = torch.cat([out, out.new_zeros(pad)], dim) if pad[dim] else out
        pieces = [torch.empty_like(padded) for _ in range(parts)]
        dist.all_gather(pieces, padded.contiguous(), group=group)
        out = torch.cat([piece.narrow(dim, 0, w) for piece, w in zip(pieces, widths)], dim)
    return out


def split_shard_worker(rank: int, world: int, port: int, split: str, cells: str) -> None:
    """One of ``world`` processes sharing the card in a gloo group, on the
    (1, world) mesh with ``split`` (C, I or K) over its second axis: each
    cell of ``cells`` ("brats", "config1"; comma-separated) on its block,
    against its region of the unsharded call, with the stages that entered
    ``gathered`` and its peak; prints one JSON line."""
    import json as json_mod

    import torch
    import torch.distributed as dist

    import torchio_tpu_torch as tio
    from torchio_tpu_torch.parallel import make_mesh
    from torchio_tpu_torch.parallel.mesh import local_slices

    if DEVICE == "cuda":
        from torch.distributed.tensor import DTensor

        torch.cuda.set_device(0)
        DTensor.full_tensor = gloo_full_tensor
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        dev = torch.device(DEVICE)
        sharding = split_sharding(make_mesh(DEVICE, space=world), split)
        makers = {
            "brats": (brats_preprocess,
                      lambda: make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0)),
            "config1": (config1_pipeline,
                        lambda: make_batch(tio, torch, B, CONFIG1_SHAPE, dev, 1)),
        }
        parts = {}
        for cell in cells.split(","):
            make_pipeline, make = makers[cell]
            batch = make()
            tio.seed(LABEL_SEED)  # peak_call's seed
            ref = make_pipeline(tio)(copy.deepcopy(batch))
            # each image's region, off the card: not in the peak
            want = {n: ib.data[local_slices(ib.data.shape, sharding)].cpu()
                    for n, ib in ref.images.items()}
            del ref
            batch.shard_(sharding)
            with GatherSpy(torch, tio) as spy:
                out, resident, peak = peak_call(torch, tio, make_pipeline(tio), batch)
            parts[cell] = {
                "equal": all(torch.equal(ib.data.to_local().cpu(), want[n])
                             for n, ib in out.images.items()),
                "entered": [e for e in spy.entered if e],
                "gathers": sum(g == "DTensor.full_tensor" for g, _ in spy.gathers),
                "local_shapes": {n: list(ib.data.to_local().shape)
                                 for n, ib in out.images.items()},
                "resident": resident, "peak": peak,
            }
            del batch, out, want
            torch.cuda.empty_cache()
        print(json_mod.dumps({"rank": rank, "parts": parts}))
    finally:
        dist.destroy_process_group()


def parallel_split_processes(torch, tio, smi):
    """brats-preprocess-fused and config 1 split along I as 2 processes
    and along K as 4, and brats-preprocess-fused split along C as 2 and 4
    processes, sharing the card in a gloo group (:func:`split_shard_worker`;
    on the card ``DTensor.full_tensor`` is :func:`gloo_full_tensor`): each
    stage takes the whole batch (a fused run enters ``gathered`` once, one
    gather an image), every block equal to its region of the unsharded
    call; the stages that entered ``gathered`` and each process's peak,
    beside the unsharded call's."""
    dev = torch.device(DEVICE)
    unsharded = {}
    for cell, make_pipeline, make in (
            ("brats", brats_preprocess,
             lambda: make_brats_batch(tio, torch, BRATS_B, BRATS_SHAPE, dev, 0)),
            ("config1", config1_pipeline, lambda: make_batch(tio, torch, B, CONFIG1_SHAPE, dev, 1))):
        out, resident, peak = peak_call(torch, tio, make_pipeline(tio), make())
        unsharded[cell] = {"resident": resident, "peak": peak}
        del out
        torch.cuda.empty_cache()
    report = {}
    mib = 2**20
    for split, world, cells in SPLIT_PROCESS_RUNS:
        layout = f"{split} split, {world} processes"
        results, errors = shard_processes(world, worker="split_shard_worker",
                                          extra=f", {split!r}, {','.join(cells)!r}")
        if errors or len(results) != world:
            fail(f"the {layout}: {len(results)} of {world} gave a result; their errors:\n"
                 + "\n---\n".join(errors))
        bad = [(r["rank"], cell) for r in results for cell, e in r["parts"].items()
               if not e["equal"]]
        if bad:
            fail(f"the {layout}: blocks {bad} differ from their region of the unsharded call")
        for r in results:
            for cell, e in r["parts"].items():
                if not e["entered"] or e["gathers"] != len(e["local_shapes"]) * len(e["entered"]):
                    fail(f"the {layout}: {cell} on rank {r['rank']} entered gathered"
                         f" {e['entered']} with {e['gathers']} gathers")
        report[layout] = results
        print(
            f"{layout} sharing the card (gloo; full_tensor by dist.all_gather on the card): every"
            " block equal to its region of the unsharded call; " + "; ".join(
                f"{cell}: entered gathered {results[0]['parts'][cell]['entered']}, blocks"
                f" {results[0]['parts'][cell]['local_shapes']} on rank 0, peaks"
                f" {[round(r['parts'][cell]['peak'] / mib) for r in results]} MiB a process"
                f" (resident {[round(r['parts'][cell]['resident'] / mib) for r in results]} MiB)"
                f" against {round(unsharded[cell]['peak'] / mib)} MiB unsharded (resident"
                f" {round(unsharded[cell]['resident'] / mib)} MiB)"
                for cell in cells
            ) + f"; card: {smi}"
        )
    return {"unsharded_mib": {c: {k: v / mib for k, v in u.items()} for c, u in unsharded.items()},
            "runs": {layout: [{cell: {"entered": e["entered"], "peak_mib": e["peak"] / mib,
                                      "resident_mib": e["resident"] / mib}
                               for cell, e in r["parts"].items()} for r in results]
                     for layout, results in report.items()}}


def bias_noise(tio):
    """The headline's pointwise stages: BiasField + Noise, fused."""
    return tio.Compose([tio.BiasField(std=0.5), tio.Noise(std=0.1)], fuse=True)


def shard_worker(rank: int, world: int, port: int) -> None:
    """One of ``world`` processes sharing the card in a gloo group: the
    headline's BiasField + Noise on its J slab of a (1, world) layout,
    against its slab of the unsharded call; prints one JSON line."""
    import json as json_mod

    import torch
    import torch.distributed as dist

    import torchio_tpu_torch as tio
    from torchio_tpu_torch.parallel import make_mesh

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        dev = torch.device(DEVICE)
        mesh = make_mesh(DEVICE, space=world)
        batch = make_batch(tio, torch, B, (S, S, S), dev, PARALLEL_SEED)
        tio.seed(PARALLEL_SEED)
        ref = bias_noise(tio)(copy.deepcopy(batch)).t1.data
        jl = S // world
        want = ref[:, :, :, rank * jl:(rank + 1) * jl].cpu()  # off the card: not in the peak
        del ref
        batch.shard_(mesh, spatial=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tio.seed(PARALLEL_SEED)
        out = bias_noise(tio)(batch).t1.data
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        local = out.to_local()
        print(json_mod.dumps({
            "rank": rank, "equal": bool(torch.equal(local.cpu(), want)),
            "local_shape": list(local.shape), "resident": resident, "peak": peak,
        }))
    finally:
        dist.destroy_process_group()


#: what gloo says where it refuses an op on a CUDA tensor: the one
#: failure of the processes that sends the layouts to the simulated shards
GLOO_REFUSES_CUDA = (
    r"ProcessGroupGloo::\w+: unsupported device type"
    r"|No backend type associated with device type cuda"
    r"|a Tensor with unexpected device type"
)


def shard_processes(world: int, timeout: float = 240.0, prelude: str = "",
                    worker: str = "shard_worker", extra: str = ""):
    """``world`` processes of ``worker`` (:func:`shard_worker`, or
    :func:`label_shard_worker` with ``extra`` arguments) on the one card;
    their JSON lines, and for each process that failed its error: the tail
    of its standard error, or the time it outlived (every process
    stopped). ``prelude``: Python run in each process before the
    worker."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    here = Path(__file__).resolve().parent
    code = prelude + f"\nimport chip_smoke as cs; cs.{worker}({{}}, {world}, {port}{extra})"
    procs = [
        subprocess.Popen([sys.executable, "-c", code.format(rank)], cwd=here,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)
    ]
    results, errors = [], []
    deadline = time.time() + timeout
    try:
        for proc in procs:
            try:
                out, err = proc.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                errors.append(f"a process did not finish in {timeout:.0f} s")
                break
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if proc.returncode != 0 or not lines:
                tail = "\n".join(err.strip().splitlines()[-12:])
                errors.append(f"rc {proc.returncode}, no JSON line" if not tail else tail)
            else:
                results.append(json.loads(lines[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results, errors


def simulated_bias_noise(torch, tio, world: int, batch, ref, params):
    """Each shard's local program of BiasField + Noise on a (1, world)
    layout (a region cut by hand: no process group), from the unsharded
    call's recorded params; each output slab against the unsharded one,
    with its peak memory."""
    import numpy as np

    from torchio_tpu_torch.parallel.mesh import Region
    from torchio_tpu_torch.transforms.intensity.bias_field import biased_region
    from torchio_tpu_torch.transforms.intensity.noise import noisy_region

    bias, noise = params
    x = batch.t1.data
    jl = S // world
    report = []
    for s in range(world):
        slab = x[:, :, :, s * jl:(s + 1) * jl].contiguous()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        region = Region(slab, tuple(x.shape), (0, 0, 0, s * jl, 0))
        out = biased_region(region, np.asarray(bias["std"], np.float32), bias["seed"],
                            bias["scale"], False)
        mean = torch.as_tensor(noise["mean"], device=slab.device).reshape(-1, 1, 1, 1, 1)
        std = torch.as_tensor(noise["std"], device=slab.device).reshape(-1, 1, 1, 1, 1)
        out = noisy_region(noise["seed"], 0, Region(out, tuple(x.shape), region.starts), mean,
                           std, False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        equal = torch.equal(out, ref[:, :, :, s * jl:(s + 1) * jl])
        report.append({"rank": s, "equal": bool(equal), "local_shape": list(out.shape),
                       "resident": resident, "peak": peak})
        del slab, out
    return report


def parallel_local_programs(torch, tio, smi):
    """The headline's BiasField + Noise on each shard of a (1, 2) and a
    (1, 4) layout, against the unsharded call's slabs, with peak memory:
    first as 2 and 4 processes sharing the card in a gloo group; where
    that fails, as each shard's local program in this process."""
    dev = torch.device(DEVICE)
    batch = make_batch(tio, torch, B, (S, S, S), dev, PARALLEL_SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tio.seed(PARALLEL_SEED)
    out = bias_noise(tio)(copy.deepcopy(batch))
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated()
    ref = out.t1.data
    params = [t.params for t in out.applied_transforms]
    report = {"unsharded": {"resident": resident, "peak": whole_peak}}
    for world in PARALLEL_LAYOUTS:
        results, errors = shard_processes(world)
        route = "processes"
        if errors or len(results) != world:
            refusals = [m for e in errors for m in re.findall(f".*(?:{GLOO_REFUSES_CUDA}).*", e)]
            if not refusals:
                fail(f"BiasField + Noise as {world} processes sharing the card in a gloo group:"
                     f" {len(results)} of {world} gave a result; their errors:\n"
                     + "\n---\n".join(errors))
            route = f"simulated (gloo refused a CUDA tensor: {refusals[0].strip()})"
            results = simulated_bias_noise(torch, tio, world, batch, ref, params)
        bad = [r["rank"] for r in results if not r["equal"]]
        if bad:
            fail(f"BiasField + Noise on (1, {world}) ({route}): shards {bad} differ from their slab")
        report[f"(1, {world})"] = {"route": route, "shards": results}
    del batch, out, ref
    torch.cuda.empty_cache()
    mib = 2**20
    print(
        "BiasField + Noise on each shard's slab (equal to the unsharded call's slab): unsharded"
        f" B={B} x {S}^3 peak {whole_peak / mib:.0f} MiB (input resident {resident / mib:.0f}"
        " MiB); " + "; ".join(
            f"{layout} by {entry['route']}: peaks "
            f"{[round(r['peak'] / mib) for r in entry['shards']]} MiB (resident "
            f"{[round(r['resident'] / mib) for r in entry['shards']]} MiB)"
            for layout, entry in report.items() if layout != "unsharded"
        ) + f"; card: {smi}"
    )
    return report


def phase_parallel(torch, np, tio, tr, tk, kl, smi):
    """torch.distributed on the card: a one-rank NCCL group and its (1, 1)
    mesh; the headline on a J-sharded batch; each shard's local program of
    a (1, 2) and a (1, 4) layout fed its neighbours' halos; the fused
    step; sharded patch inference; a 256 MiB volume file to file; the
    threefry counter base; the strided segment against its plain version
    and the headline's Noise draw as J slabs; configs 1 and 2 and
    brats-preprocess-fused sharded with no gather; the headline's
    BiasField + Noise on each shard of (1, 2) and (1, 4), as processes
    sharing the card in a gloo group (or each shard's local program); the
    label and index pipelines sharded with no gather, the
    collective-free label stages as processes at (2, 1), (1, 2) and
    (1, 4), and Contour's and the reflect Pad's J planes as each shard's
    local program; synthseg-labels-to-image, ixi-preprocess-histstd (from
    "PLI"), kspace-motion-ghosting and config4-elastic-inverse sharded
    with no gather, and LabelsToImage given its label set, the recorded
    pointwise inverses and k-space on a B split as processes; the
    headline, brats-preprocess-fused and ixi-preprocess-histstd on the
    one-rank mesh split along I and along K with no stage in ``gathered``,
    and brats-preprocess-fused and config 1 split along C, I and K as 2
    and 4 processes, each stage on the whole batch."""
    import torch.distributed as dist

    from torchio_tpu_torch.parallel import halo as halo_mod

    t0 = time.perf_counter()
    mesh = nccl_mesh(torch)
    try:
        halo_launches, batch = parallel_headline(torch, tio, kl, mesh, smi)
        kl.reset_launches()
        resample_report, simulated = simulate_resample(torch, np, halo_mod, kl, batch, mesh)
        blur_report = simulate_blur(torch, halo_mod, batch, mesh)
        inference_report = simulate_inference(torch, np, halo_mod, batch, mesh)
        del batch
        print(
            f"simulated shards (each shard's local program fed the halos its neighbours would"
            f" send, reassembled against the (1, 1) program): halo_resample_spec"
            f" {resample_report} ({simulated} resample_coords launches); halo_blur"
            f" {blur_report}; sharded_grid_inference's fold {inference_report}"
        )
        step_launches = parallel_step(torch, np, tio, kl, mesh)
        parallel_inference(torch, np, tio, mesh)
        parallel_large(torch, np, tio, mesh, smi)
        counter = counter_base(torch, tr, tk)
        strided = strided_segments(torch, tr, tk, kl, smi)
        pipelines = parallel_pipelines(torch, tio, kl, mesh, smi)
        label_pipelines = parallel_label_pipelines(torch, np, tio, kl, mesh, smi)
        cells = parallel_gather_free_cells(torch, np, tio, kl, mesh, smi)
        splits = parallel_splits(torch, np, tio, kl, mesh, smi)
    finally:
        dist.destroy_process_group()
    local_programs = parallel_local_programs(torch, tio, smi)
    label_processes = parallel_label_processes(torch, tio, smi)
    free_processes = parallel_free_processes(torch, tio, smi)
    split_processes = parallel_split_processes(torch, tio, smi)
    label_planes = simulate_label_planes(torch, tio, smi)
    print(f"parallel: {time.perf_counter() - t0:.1f} s; card: {smi}")
    return {"halo_launches": halo_launches, "simulated_launches": simulated,
            "step": step_launches, "counter_base": counter, "strided": strided,
            "pipelines": pipelines, "local_programs": local_programs,
            "label_pipelines": label_pipelines, "label_processes": label_processes,
            "label_planes": label_planes, "cells": cells, "free_processes": free_processes,
            "splits": splits, "split_processes": split_processes}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--profile", metavar="PATH", help="write a torch.profiler table to PATH"
    )
    args = parser.parse_args()
    started = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")

    import numpy as np

    import torchio_tpu_torch as tio
    from torchio_tpu_torch import config, native
    from torchio_tpu_torch import random as tr
    from torchio_tpu_torch.ops import bspline as bs
    from torchio_tpu_torch.ops import bspline_kernel as bk
    from torchio_tpu_torch.ops import kernel_lib as kl
    from torchio_tpu_torch.ops import resample_kernel as rk
    from torchio_tpu_torch.ops import threefry_kernel as tk

    # the ops package exports the function ``resample`` under its module's name
    rs = importlib.import_module("torchio_tpu_torch.ops.resample")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.profile:
        Path(args.profile).unlink(missing_ok=True)
    smi = phase_device(torch, config)
    phase_build(kl, native)
    phase_kernel(torch, np, rs, rk, kl)
    phase_label_kernel(torch, np, rs, rk, kl)
    phase_prefilter_kernel(torch, np, bs, bk, kl)
    phase_spline_kernel(torch, np, rs, bs, bk, kl)
    phase_coords_kernel(torch, np, rs, rk, kl)
    phase_coords_spline_kernel(torch, np, rs, bs, bk, kl)
    phase_threefry_kernel(torch, tr, tk, kl)
    phase_small_slice(torch, tio)
    phase_small_labelled(torch, np, tio, rs)
    phase_small_kspace(torch, tio, kl)
    phase_small_config(torch, tio, 1)
    phase_small_config(torch, tio, 2)
    phase_small_config3(torch, np, tio, rs, kl)
    phase_small_config4(torch, np, tio, rs, kl)
    phase_small_patches(torch, np, tio, tr, kl)
    phase_small_policy(torch, np, tio, rs, kl)
    phase_small_kspace_oneof(torch, tio, kl)
    phase_small_brats_preprocess(torch, tio, kl)
    phase_small_zoo(torch, np, tio)
    phase_small_integers(torch, np, tio)
    phase_small_zoo_paths(torch, np, tio, rs)
    phase_small_io(torch, np, tio, native)
    phase_host_subject(torch, np, tio, kl)
    headline_launches = phase_slice(torch, tio, kl, args.profile)
    brats_launches, brats_batch = phase_brats(torch, tio, kl, args.profile)
    kspace_launches = phase_kspace(torch, tio, kl, args.profile)
    config1_launches = phase_config(torch, tio, kl, 1, args.profile)
    config2_launches = phase_config(torch, tio, kl, 2, args.profile)
    config3_launches, config3_batch = phase_config3(torch, tio, kl, args.profile)
    config4_launches = phase_config4(torch, tio, kl, args.profile)
    config5_launches, config5_locations = phase_config5_queue(torch, tio, kl, args.profile)
    config5_nifti_launches = phase_config5_nifti_queue(
        torch, tio, kl, native, smi, config5_locations, args.profile
    )
    phase_config5_aggregator(torch, np, tio, args.profile)
    policy_launches_total = phase_policy(torch, tio, kl, smi, args.profile)
    oneof_launches = phase_kspace_oneof(torch, tio, kl, smi, args.profile)
    phase_brats_preprocess(torch, tio, kl, smi, args.profile)
    synthseg_launches = phase_synthseg(torch, tio, kl, smi, args.profile)
    ixi_launches = phase_ixi(torch, np, tio, kl, smi, args.profile)
    ixi_nifti_launches = phase_ixi_nifti(torch, np, tio, kl, native, smi, args.profile)
    phase_ux(torch, np, tio, tr, kl)
    parallel = phase_parallel(torch, np, tio, tr, tk, kl, smi)
    ct_launches, ct_volume, ct_written = phase_ct_dicom(torch, np, tio, kl, native, smi, args.profile)
    phase_ct_codecs(torch, np, tio, native, smi, ct_volume, ct_written)
    del ct_volume
    phase_zoo_timing(torch, tio, smi)
    timings = {"resample": phase_kernel_timing(torch, np, tio, rs, rk)}
    timings.update(phase_brats_timing(torch, np, tio, rs, rk, bs, bk, brats_batch))
    del brats_batch
    dense, dense_launches = phase_dense_entry(torch, np, tio, rs, rk, bs, bk, kl)
    timings.update(dense)
    timings["threefry_normal"] = phase_threefry_timing(torch, config, tr, tk)
    timings["resample_diagonal"] = phase_diagonal_timing(torch, np, tio, rs, rk, config3_batch)
    del config3_batch
    timings["threefry_bits"], ring_sample_launches = phase_ring_sample_timing(torch, tr, tk, kl)
    window = "torchio_tpu/ops/window_resample.py:335"
    launches = {
        "resample": headline_launches["resample"],
        "label_vote": brats_launches["label_vote"],
        "bspline_prefilter": brats_launches["bspline_prefilter"],
        "bspline_resample": brats_launches["bspline_resample"],
        "resample_coords": kspace_launches["resample_coords"],
        "bspline_coords": dense_launches["bspline_coords"],
        "threefry_normal": headline_launches["threefry_normal"],
        "resample_diagonal": config3_launches["resample"],
        "threefry_bits": ring_sample_launches,
    }
    resample_paths = {
        "headline": headline_launches["resample"],
        "config3-affine-resample": config3_launches["resample"],
        "config4-elastic-inverse": config4_launches["resample"],
        "policy-someof": policy_launches_total["resample"],
        "synthseg-labels-to-image": synthseg_launches["resample"],
        "ixi-preprocess-histstd": ixi_launches["resample"],
        "ixi-nifti-preprocess": ixi_nifti_launches["resample"],
        "ct-dicom-preprocess": ct_launches["resample"],
    }
    threefry_paths = {
        "headline": headline_launches["threefry_normal"],
        "brats-label-bspline": brats_launches["threefry_normal"],
        "config1-flip-noise-rescale": config1_launches["threefry_normal"],
        "config2-blur-bias-gamma": config2_launches["threefry_normal"],
        "config3-affine-resample": config3_launches["threefry_normal"],
        "config4-elastic-inverse": config4_launches["threefry_normal"],
        "policy-someof": policy_launches_total["threefry_normal"],
        "synthseg-labels-to-image": synthseg_launches["threefry_normal"],
        "ct-dicom-preprocess": ct_launches["threefry_normal"],
    }
    kernels = [
        {
            "name": "resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": ["torchio_tpu/ops/shear_resample.py:81", window],
            "note": f"launches on the headline; per path: {resample_paths}",
            "path": "headline",
        },
        {
            "name": "label_vote",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/label_resample.cu",
            "replaces": "torchio_tpu/ops/shear_resample.py:219",
            "also_replaces": [window],
            "path": "brats-label-bspline",
        },
        {
            "name": "bspline_prefilter",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": "torchio_tpu/ops/bspline.py:81",
            "note": "XLA lax.scan prefilter in the JAX package; no Pallas counterpart",
            "path": "brats-label-bspline",
        },
        {
            "name": "bspline_resample",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "path": "brats-label-bspline",
        },
        {
            "name": "resample_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/pallas_resample.py:117",
            "note": "launches on kspace-motion-ghosting; config5-queue-labelsampler"
            f" (Motion in the Queue's transform, {CONFIG5_WARMUP + CONFIG5_TIMED} epochs of"
            f" {CONFIG5_SUBJECTS} subjects): {config5_launches['resample_coords']}, one a"
            " subject that kept Motion; config5-nifti-queue (the same over subjects read from"
            f" .nii files): {config5_nifti_launches['resample_coords']}; kspace-oneof (per element,"
            " B=4, 7 calls):"
            f" {oneof_launches['resample_coords']}, one a move of an element that drew"
            " Motion (2 moves each); parallel (the halo program of Spatial on the headline"
            f" sharded over J, mesh (1, 1)): {parallel['halo_launches']} a call; the sharded"
            f" step: {parallel['step']['resample_coords']} a call; the simulated shards of"
            f" (1, 2) and (1, 4): {parallel['simulated_launches']}, one a shard; the sharded"
            " labels pipeline (Spatial's halo program on synthseg's J-sharded label maps):"
            f" {parallel['label_pipelines']['labels']['launches'].get('resample_coords', 0)}"
            " a call",
            "path": "kspace-motion-ghosting",
            "halo_launches": parallel["halo_launches"],
        },
        {
            "name": "bspline_coords",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/bspline.cu",
            "replaces": window,
            "note": "dense-coordinate mode; the JAX package's dense bspline_resample"
            " (torchio_tpu/ops/bspline.py:215) is an XLA gather",
            "path": "dense-entry",
        },
        {
            "name": "threefry_normal",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/threefry.cu",
            "replaces": "torchio_tpu/transforms/fuse.py:197",
            "also_replaces": [
                "torchio_tpu/transforms/fuse.py:195",
                "torchio_tpu/transforms/intensity/noise.py:121",
                "torchio_tpu/transforms/intensity/bias_field.py:42",
                "torchio_tpu/transforms/intensity/bias_field.py:65",
            ],
            "note": "jax.random.normal (threefry2x32, Giles' erf_inv) is XLA in the JAX"
            " package, no Pallas kernel; launches on the headline, per path:"
            f" {threefry_paths}; torch.randn (Philox, not the same function)"
            f" {timings['threefry_normal']['randn_ms']:.3f} ms; the sharded step draws its"
            " bias rows and its noise region (a strided segment) in one launch:"
            f" {parallel['step']['threefry_normal']} a call; strided segments (a rank's J slab)"
            " against the plain version and the headline's Noise draw as a J half and quarter"
            " slab under 'strided'",
            "path": "headline",
            "counter_base": parallel["counter_base"],
            "strided": parallel["strided"],
        },
        {
            "name": "resample_diagonal",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/resample.cu",
            "replaces": "torchio_tpu/ops/resample.py:298",
            "note": "the resample kernel (tio_resample) on config 3's diagonal 2 mm ->"
            " 1 mm map; the JAX package computes a diagonal map with XLA separable"
            " matmuls (_resample_element_separable), no Pallas kernel; launches: every"
            " resample launch of the config 3 path, 4 a call (Affine and Resample, ch"
            " and seg); ixi-preprocess-histstd (t1 linear and seg nearest from 0.9375 x"
            f" 0.9375 x 1.2 mm to 1 mm, 7 calls): {ixi_launches['resample']};"
            " ixi-nifti-preprocess (the same from int16 .nii.gz files to a 1 mm reference file,"
            f" {IXI_FILE_WARMUP + IXI_FILE_TIMED} calls): {ixi_nifti_launches['resample']}; library:"
            " F.interpolate(trilinear, align_corners=False)",
            "path": "config3-affine-resample",
        },
        {
            "name": "threefry_bits",
            "route": "cuda",
            "source": "torchio_tpu_torch/csrc/threefry.cu",
            "replaces": "torchio_tpu/ops/patches.py:115",
            "note": "jax.random.randint's two words (XLA in the JAX package, no Pallas"
            " kernel): the threefry kernel's bits mode, both words in one launch of two"
            " segments, through random.key_randint on RingPatchBuffer.sample; launches: one"
            " call of sample on config 5's ring; no library call draws jax.random's words",
            "path": "ring-sample",
        },
    ]
    for entry in kernels:
        t = timings[entry["name"]]
        bound_ms, bound_by = t["bound"]
        entry.update(
            launches=launches[entry["name"]],
            max_abs_err=t["max_abs_err"],
            ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=bound_ms,
            bound_by=bound_by,
            roofline=bound_ms / t["ms"],
            library_ms=t.get("library_ms"),
        )
        for key in ("pass_ms", "b4"):
            if key in t:
                entry[key] = t[key]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s, the build included")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
