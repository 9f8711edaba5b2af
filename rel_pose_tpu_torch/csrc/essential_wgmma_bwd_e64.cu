// The e = 64 variants (no positional encoding) of the bf16 essential
// block's backward on wgmma (essential_wgmma.cuh), instantiated in a
// translation unit of their own so that nvcc builds them in parallel.

#include "essential_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

RP_EW_VARIANTS(RP_EWB_BWD_INSTANTIATE, kHeadDim)

}  // namespace wg
}  // namespace tc
}  // namespace rp
