// Kernel #8's fp32 forward (bilinear.cu) on the tensor-core moments of
// essential_tc.cuh, SliceLayout as 3xTF32, instantiated in a translation
// unit of its own so that nvcc builds it beside the other kernels.

#include "essential_tc.cuh"

namespace rp {
namespace tc {

template cudaError_t launch_slice_moments<float>(const EbFwdArgsT<float>&,
                                                 int, int, cudaStream_t);

}  // namespace tc
}  // namespace rp
