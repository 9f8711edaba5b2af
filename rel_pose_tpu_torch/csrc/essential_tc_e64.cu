// The e = 64 variants (no positional encoding) of the Essential Matrix
// Module's tensor-core moments (essential_tc.cuh), bf16 and fp32,
// instantiated in a translation unit of their own so that nvcc builds them
// in parallel.

#include "essential_tc.cuh"

namespace rp {
namespace tc {

RP_EB_TC_VARIANTS(RP_EB_TC_INSTANTIATE, kHeadDim)

}  // namespace tc
}  // namespace rp
