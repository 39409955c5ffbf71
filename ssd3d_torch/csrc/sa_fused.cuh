// K7's tile and envelope, in one place: `sa_fused.cu` compiles with these
// numbers and `ops/sa_fused.py` reads them from this file (`supports`,
// `smem_bytes`), so the Python gate and the C launcher cannot drift apart.
// Keep each on a line of its own as `constexpr int kName = value;`.
#pragma once

namespace k7 {

constexpr int kRows = 128;         // rows (centre x sample) a block computes
constexpr int kCols = 128;         // output columns per pass: 16 thread columns x 8
constexpr int kKC = 16;            // input channels per staged weight chunk
constexpr int kMaxScales = 4;      // radius scales of one SA layer
constexpr int kMaxLayers = 4;      // folded layers of one scale
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may opt in to (H100)

}  // namespace k7
