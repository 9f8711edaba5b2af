// The e = 70 variants (positional columns) of the fp32 essential block's
// forward on TF32 wgmma (essential_wgmma_f32.cuh), and #9's s (S slices a
// block), instantiated in a translation unit of their own so that nvcc
// builds them in parallel.

#include "essential_wgmma_f32.cuh"

namespace rp {
namespace tc {
namespace wg {

RP_EW_VARIANTS(RP_EW_FWD_INSTANTIATE, kHeadDim + kEbPos)
template cudaError_t launch_moments_wg<kHeadDim + kEbPos, false, false, true>(
    const EbTcArgs<float>&, cudaStream_t, int);

}  // namespace wg
}  // namespace tc
}  // namespace rp
