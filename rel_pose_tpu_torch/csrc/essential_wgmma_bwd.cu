// The e = 70 variants (positional columns) of the bf16 essential block's
// backward on wgmma (essential_wgmma.cuh), instantiated in a translation
// unit of their own so that nvcc builds them in parallel.

#include "essential_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

RP_EW_VARIANTS(RP_EWB_BWD_INSTANTIATE, kHeadDim + kEbPos)

}  // namespace wg
}  // namespace tc
}  // namespace rp
