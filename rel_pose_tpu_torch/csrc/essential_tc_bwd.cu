// The e = 70 variants (positional columns) of the Essential Matrix Module's
// tensor-core backward (essential_tc_bwd.cuh), bf16 and fp32, instantiated
// in a translation unit of their own so that nvcc builds them beside the
// other kernels.

#include "essential_tc_bwd.cuh"

namespace rp {
namespace tc {

RP_EB_TC_VARIANTS(RP_EBB_TC_INSTANTIATE, kHeadDim + kEbPos)

}  // namespace tc
}  // namespace rp
