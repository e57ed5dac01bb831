// The segment plan's contract shared by segment_plan.cu (which builds it)
// and segment_max.cu (whose pools read it); `kernels/segmax.py`
// SEGMENT_LONG and SEGMENT_WORK are the same numbers.
#pragma once

namespace tdv {

// a segment of more rows than this is pooled by many blocks, not one warp
constexpr int kSegmentLong = 256;
// a pool warp's share of the work: segment s costs 1 + its rows and starts
// at offsets[s] + s; warp w takes the segments that start in
// [w * kSegmentWork, (w + 1) * kSegmentWork)
constexpr int kSegmentWork = 32;

}  // namespace tdv
