// The limits of one K1/K2 launch (conv3d_wgmma.cu): parts summed into one
// output, K2's output phases, taps of a kernel (ops/convolution.py mirrors
// them: MAX_PARTS, MAX_PHASES, MAX_TAPS).
#pragma once

namespace pmr {

// a dense-skip ladder's stage-0 stitch has 6 parts; ops/convolution.py MAX_PARTS
constexpr int kMaxParts = 6;
constexpr int kMaxPhases = 8;
constexpr int kMaxTaps = 27;

}  // namespace pmr
