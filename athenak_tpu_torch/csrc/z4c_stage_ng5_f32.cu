// Kernel H in vacuum for nghost 5 in float; see z4c_rhs.cuh.  One file
// for each (nghost, type, matter), so that the parallel build compiles
// the sixteen at once (z4c_matter_ng*_f*.cu: the matter source).

#include "z4c_rhs.cuh"

namespace athenak {
template int z4c_stage_launch<float, 5, false>(const Z4cArgs&);
}  // namespace athenak
