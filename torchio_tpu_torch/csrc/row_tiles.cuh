// The row-tiled launch shared by the grid-spec kernels of resample.cu
// (trilinear / nearest, and their dense-coordinate mode) and
// label_resample.cu (the label vote): which output voxels a block, a warp
// and a lane serve, and what one output row (b, io, jo) sets up once for
// its voxels. A kernel brings its per-voxel work as a Body (below); the
// row loops here run it.
//
//   - a block is kRows warps; a warp owns one output row (b, io, jo) and
//     walks the row's k tiles of kTileK ko assigned to its block, kVec
//     voxels a lane. A 3-D launch grid (k tiles, j tiles, io x b) gives
//     each block its rows with 32-bit arithmetic; the axes past CUDA's
//     65,535 cap on grid y and z fold into loops inside the block
//     (ops/resample_kernel.py::resample_launch_plan, which also gives a
//     block two k tiles of a row);
//   - what a row shares is computed once a row (Row): the map's
//     i m0 + j m1, and the field's i- and j-lerps at each of the nk coarse
//     k points (upsample_field's own intermediate), staged in shared
//     memory, so a voxel keeps only its k-lerp. A field too fine to stage
//     (the plan's field_smem 0) is upsampled whole a voxel.
//
// Every file that includes this header is built with -fmad=false (see
// sample_point.cuh).

#pragma once

#include "sample_point.cuh"

namespace tio {

// The launch shape; ops/resample_kernel.py mirrors these numbers.
constexpr int kLanes = 32;             // a warp along one row's k
constexpr int kRows = 8;               // warps (output rows) a block
constexpr int kVec = 4;                // voxels a lane in a k tile
constexpr int kTileK = kLanes * kVec;  // ko of a k tile

// The ko of a lane's voxel v, for a layout L: kVec consecutive ko a lane
// (L::kConsecutive), or a warp's lanes on consecutive ko, a lane's voxels
// a warp-width apart.
template <class L>
__device__ __forceinline__ unsigned ko_of(unsigned k_first, unsigned lane, int v) {
  return L::kConsecutive ? k_first + lane * kVec + v : k_first + lane + v * kLanes;
}

__device__ __forceinline__ int clamp_index(int i, int n) { return min(max(i, 0), n - 1); }

// The pointer as computed, hidden from the optimiser: a load is then its
// 32-bit offset scaled onto it (one IMAD.WIDE), where the compiler
// otherwise folds the 64-bit (b, c) base into every load's address (four
// instructions each).
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm("" : "+l"(p));
  return p;
}

// The field's i-lerp and then j-lerp at the row (io, jo), at each of the
// nk coarse k points: the (nk, 3) slice of upsample_field's intermediate
// after its i and j passes, in sample_point's operation order. The warp's
// lanes share the nk * 3 entries.
__device__ __forceinline__ void stage_row_field(const float* __restrict__ fields,
                                                const Grid& s, unsigned b, unsigned io,
                                                unsigned jo, unsigned lane,
                                                float* row_field) {
  int i0, i1, j0, j1;
  float fi, fj;
  coarse_axis((int)io, s.ni, s.ri, i0, i1, fi);
  coarse_axis((int)jo, s.nj, s.rj, j0, j1, fj);
  const int64_t line = (int64_t)s.nk * 3, plane = (int64_t)s.nj * line;
  const float* f = fields + (int64_t)b * s.ni * plane;
  const float* f00 = f + i0 * plane + j0 * line;
  const float* f10 = f + i1 * plane + j0 * line;
  const float* f01 = f + i0 * plane + j1 * line;
  const float* f11 = f + i1 * plane + j1 * line;
  __syncwarp();  // the warp has read its last row's entries
  for (int e = lane; e < s.nk * 3; e += kLanes) {
    const float along_j0 = lerp(__ldg(f00 + e), __ldg(f10 + e), fi);
    const float along_j1 = lerp(__ldg(f01 + e), __ldg(f11 + e), fi);
    row_field[e] = lerp(along_j0, along_j1, fj);
  }
  __syncwarp();
}

// The sample points of one output row (b, io, jo): what the row shares,
// set up once (the map's i m0 + j m1 and, kStaged, the field's row lerps
// staged in shared memory; or the row's coordinates), then one voxel's
// point at a time. A field too fine to stage (kStaged false) is
// upsampled whole a voxel.
template <Source kSource, bool kStaged>
struct Row {
  const float* coords;     // dense: the row's (Ko, 3) coordinates
  const float* row_field;  // kStaged: the row's (nk, 3) field lerps
  float ij[3], m2[3], m3[3];
  unsigned b, io, jo;

  __device__ __forceinline__ Row(const Points& pts, const Grid& s, unsigned b_,
                                 unsigned io_, unsigned jo_, unsigned lane, float* staged)
      : coords(nullptr), row_field(staged), b(b_), io(io_), jo(jo_) {
    if constexpr (kSource == Source::kDense) {
      coords = pts.coords + (int64_t)b * pts.batch_stride +
               ((int64_t)io * s.Jo + jo) * s.Ko * 3;
    } else {
      const float* m = pts.maps + (int64_t)b * 12;
      const float fio = (float)io, fjo = (float)jo;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ij[a] = fio * __ldg(m + 4 * a) + fjo * __ldg(m + 4 * a + 1);
        m2[a] = __ldg(m + 4 * a + 2);
        m3[a] = __ldg(m + 4 * a + 3);
      }
      if constexpr (kStaged) stage_row_field(pts.fields, s, b, io, jo, lane, staged);
    }
  }

  // The point c of voxel ko (below Ko for dense coordinates).
  __device__ __forceinline__ void point(const Points& pts, const Grid& s, unsigned ko,
                                        float c[3]) const {
    if constexpr (kSource == Source::kDense) {
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = __ldg(coords + (size_t)ko * 3 + a);
    } else {
      const float fko = (float)ko;
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = (ij[a] + fko * m2[a]) + m3[a];
      if constexpr (kSource == Source::kMapField && kStaged) {
        int k0, k1;
        float fk;
        coarse_axis((int)ko, s.nk, s.rk, k0, k1, fk);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          c[a] = c[a] + lerp(row_field[k0 * 3 + a], row_field[k1 * 3 + a], fk);
        }
      } else if constexpr (kSource == Source::kMapField) {
        const Voxel p{(int)b, (int)io, (int)jo, (int)ko};
        sample_point<true>(pts.maps, pts.fields, s, p, c);
      }
    }
  }
};

// The row loops of the launch plan: block z serves io = z % z_rows
// (stepping by z_rows) of b = z / z_rows (stepping by gridDim.z /
// z_rows); block y the j tiles y, y + gridDim.y, ...; each of its warps
// one row of the tile; block x the k tiles x, x + gridDim.x, ... of that
// row. A Body gives the kernel's arguments (Body::Args), its blocks an SM
// for __launch_bounds__ (Body::kMinBlocks: at 4, 64 registers a thread),
// and its work on a lane's voxels of one k tile:
//   Body::tile<kSource, kStaged>(args, pts, s, row, k_first, lane).
template <class Body, Source kSource, bool kStaged>
__global__ void __launch_bounds__(kLanes * kRows, Body::kMinBlocks)
    row_kernel(const typename Body::Args args, Points pts, Grid s, unsigned z_rows) {
  extern __shared__ float row_fields[];  // kRows x (nk, 3) when staged
  const unsigned lane = threadIdx.x;
  float* staged = row_fields + threadIdx.y * s.nk * 3;
  const unsigned b_step = gridDim.z / z_rows;
  const unsigned j_tiles = ((unsigned)s.Jo + kRows - 1) / kRows;
  const unsigned k_tiles = ((unsigned)s.Ko + kTileK - 1) / kTileK;
  for (unsigned b = blockIdx.z / z_rows; b < (unsigned)s.B; b += b_step) {
    for (unsigned io = blockIdx.z % z_rows; io < (unsigned)s.Io; io += z_rows) {
      for (unsigned jt = blockIdx.y; jt < j_tiles; jt += gridDim.y) {
        const unsigned jo = jt * kRows + threadIdx.y;
        if (jo >= (unsigned)s.Jo) continue;  // the whole warp
        const Row<kSource, kStaged> row(pts, s, b, io, jo, lane, staged);
        for (unsigned kt = blockIdx.x; kt < k_tiles; kt += gridDim.x) {
          Body::template tile<kSource, kStaged>(args, pts, s, row, kt * kTileK, lane);
        }
      }
    }
  }
}

// The launch plan of ops/resample_kernel.py::resample_launch_plan.
struct Launch {
  unsigned gx, gy, gz, z_rows;
  int wide;        // 64-bit offsets inside a (b, c) volume
  int field_smem;  // bytes of staged row fields, 0 for none
};

// Launch Body's row kernel on the plan: with the field's row lerps staged
// when the plan gives them shared memory.
template <class Body, Source kSource>
void launch_rows(const typename Body::Args& args, const Points& pts, const Grid& s,
                 const Launch& l, cudaStream_t stream) {
  const dim3 grid(l.gx, l.gy, l.gz), block(kLanes, kRows);
  if constexpr (kSource == Source::kMapField) {
    if (l.field_smem > 0) {
      row_kernel<Body, kSource, true>
          <<<grid, block, (size_t)l.field_smem, stream>>>(args, pts, s, l.z_rows);
      return;
    }
  }
  row_kernel<Body, kSource, false><<<grid, block, 0, stream>>>(args, pts, s, l.z_rows);
}

}  // namespace tio
