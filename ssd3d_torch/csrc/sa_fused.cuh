// K7's tiles and envelopes, in one place: `sa_fused.cu` compiles with these
// numbers and `ops/sa_fused.py` reads them from this file (`supports`,
// `smem_bytes`, the weight staging of the tensor-core route), so the Python
// gate and the C launcher cannot drift apart. Keep each on a line of its own
// as `constexpr int kName = value;`.
#pragma once

namespace k7 {

constexpr int kRows = 128;         // rows (centre x sample) a block computes
constexpr int kCols = 128;         // output columns a pass (tensor cores: one wgmma's N)
constexpr int kKC = 16;            // FMA route: input channels per staged weight chunk
constexpr int kMaxScales = 4;      // radius scales of one SA layer
constexpr int kMaxLayers = 4;      // folded layers of one scale
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may opt in to (H100)
constexpr int kTcPasses = 2;       // tensor-core route: column passes a layer, at most
constexpr int kTcStage = 4096;     // tensor-core route: floats a weight stage holds
constexpr int kTcStages = 5;       // tensor-core route: weight stages in the ring

}  // namespace k7
