// Kernel H with the matter source for nghost 3 in float; see
// z4c_rhs.cuh.  One file for each (nghost, type, matter), so that the
// parallel build compiles the sixteen at once.

#include "z4c_rhs.cuh"

namespace athenak {
template int z4c_stage_launch<float, 3, true>(const Z4cArgs&);
}  // namespace athenak
