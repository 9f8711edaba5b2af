// The e = 64 variants (no positional encoding) of the fp32 essential block's
// forward on TF32 wgmma (essential_wgmma_f32.cuh), instantiated in a
// translation unit of their own so that nvcc builds them in parallel.

#include "essential_wgmma_f32.cuh"

namespace rp {
namespace tc {
namespace wg {

RP_EW_VARIANTS(RP_EW_FWD_INSTANTIATE, kHeadDim)

}  // namespace wg
}  // namespace tc
}  // namespace rp
