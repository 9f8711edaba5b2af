// The e = 70 variants (positional columns) of the bf16 essential block's
// forward on wgmma (essential_wgmma.cuh), and #9's s (S slices a block),
// instantiated in a translation unit of their own so that nvcc builds them
// in parallel.

#include "essential_wgmma.cuh"

namespace rp {
namespace tc {
namespace wg {

RP_EW_VARIANTS(RP_EWB_FWD_INSTANTIATE, kHeadDim + kEbPos)
template cudaError_t launch_moments_wb<kHeadDim + kEbPos, false, false, true>(
    const EbTcArgs<bf16>&, cudaStream_t, int);

}  // namespace wg
}  // namespace tc
}  // namespace rp
