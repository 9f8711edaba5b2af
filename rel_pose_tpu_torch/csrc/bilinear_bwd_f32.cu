// Kernel #8's fp32 backward (bilinear_bwd.cu) on the tensor-core passes of
// essential_tc_bwd.cuh, SliceLayout as 3xTF32, instantiated in a
// translation unit of its own so that nvcc builds it beside the other
// kernels.

#include "essential_tc_bwd.cuh"

namespace rp {
namespace tc {

template cudaError_t launch_slice_bwd<float>(const EbBwdArgsT<float>&, int,
                                             int, cudaStream_t);

}  // namespace tc
}  // namespace rp
