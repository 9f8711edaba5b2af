// The e = 64 variants (no positional encoding) of the Essential Matrix
// Module's forward kernel, instantiated in a translation unit of their own
// so that nvcc builds them beside the e = 70 ones (essential_block.cu).

#include "essential_block.cuh"

namespace rp {

RP_EB_VARIANTS(RP_EB_FWD_INSTANTIATE, kEbHeadDim)

}  // namespace rp
