// The e = 64 variants (no positional encoding) of the Essential Matrix
// Module's backward kernel, instantiated in a translation unit of their own
// so that nvcc builds them beside the e = 70 ones (essential_block_bwd.cu).

#include "essential_block_bwd.cuh"

namespace rp {

RP_EB_VARIANTS(RP_EBB_INSTANTIATE, kEbbHeadDim)

}  // namespace rp
