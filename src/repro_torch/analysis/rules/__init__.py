"""Built-in rules. Importing this package registers them all.

| rule id                   | guards                                           |
|---------------------------|--------------------------------------------------|
| HOST-SYNC-IN-HOT-PATH     | no device->host reads on the hot paths           |
| TENSOR-PY-BRANCH          | no Python control flow on tensors there          |
| RNG-GENERATOR             | every draw from an explicit, distinct generator  |
| HOST-CONSTANT-IN-HOT-PATH | no module-level numpy array copied per hot call  |
| KERNEL-BUILD-IN-LOOP      | kernels built (nvcc, dlopen) outside loops       |
| TF32-ON                   | TF32 never switched on                           |
| DTYPE-PLANE-CONTRACT      | documented (N, Dflat)/(D, N, Dflat)/(D, N, N)    |
| MARKER-DISCIPLINE         | parity/mesh/hypothesis batteries marked slow     |

The torch rules have ids of their own (the reference's are
RNG-KEY-REUSE, TRACED-PY-BRANCH, HOST-SYNC-IN-JIT and
JIT-RECOMPILE-HAZARD), so that one suppression comment means one thing
to both analyzers; MARKER-DISCIPLINE and DTYPE-PLANE-CONTRACT are the
reference's, copied.
"""
from repro_torch.analysis.rules import (  # noqa: F401  (import = register)
    contracts,
    hot,
    markers,
    rng,
    tf32,
    trace,
)
