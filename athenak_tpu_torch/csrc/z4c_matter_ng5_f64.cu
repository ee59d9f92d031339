// Kernel H with the matter source for nghost 5 in double; see
// z4c_rhs.cuh.  One file for each (nghost, type, matter), so that the
// parallel build compiles the sixteen at once.

#include "z4c_rhs.cuh"

namespace athenak {
template int z4c_stage_launch<double, 5, true>(const Z4cArgs&);
}  // namespace athenak
