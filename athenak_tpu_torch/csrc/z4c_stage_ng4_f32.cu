// Kernel H for nghost 4 in float; see z4c_rhs.cuh.  One file for each
// (nghost, type), so that the parallel build compiles the eight at once.

#include "z4c_rhs.cuh"

namespace athenak {
template int z4c_stage_launch<float, 4>(const Z4cArgs&);
}  // namespace athenak
