"""Paper math and the sketch pipeline: schemes, packing, the threefry
generator behind the canonical R, collision probabilities, estimator
variances, estimators and the optimal bin width; and the coded-sketch
gradient compressor (``gradient_compression``).

Re-exports the names the reference's ``repro.core`` does.
"""
from repro_torch.core.schemes import (  # noqa: F401
    CodeSpec, spec_for, encode, encode_uniform, encode_offset, encode_2bit,
    encode_sign, sample_offsets, collision_fraction,
)
from repro_torch.core.probabilities import (  # noqa: F401
    collision_prob, collision_prob_uniform, collision_prob_offset,
    collision_prob_2bit, collision_prob_sign, q_region, SCHEMES,
)
from repro_torch.core.variance import variance_factor, dP_drho  # noqa: F401
from repro_torch.core.estimators import (  # noqa: F401
    CollisionEstimator, MleRhoEstimator, cell_probs, mle_rho_2bit,
    region_bounds, rho_from_sign_collision,
)
from repro_torch.core.optimal import optimal_w  # noqa: F401
from repro_torch.core.packing import pack_codes, unpack_codes  # noqa: F401
from repro_torch.core.sketch import (  # noqa: F401
    SketchConfig, CodedRandomProjection,
)
from repro_torch.core.gradient_compression import (  # noqa: F401
    GradCompressionConfig, GradCompressor, code_centroids,
)
