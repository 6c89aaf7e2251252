"""Steerable filter banks: the G2/H2 quadrature pair and the G4/H4
extension (the exports of cvsteer_tpu.filters)."""

from cvsteer_tpu_torch.filters.taps import (  # noqa: F401
    SeparableBank,
    g2h2_bank,
    g4h4_bank,
    sample_taps,
)
from cvsteer_tpu_torch.filters.g2 import (  # noqa: F401
    G2Bank,
    G2Maps,
    g2_bank,
    g2_basis,
    g2_output_maps,
    steerable_pipeline_g2,
)
from cvsteer_tpu_torch.filters.g4 import (  # noqa: F401
    G4Bank,
    G4Maps,
    g4_bank,
    g4_basis,
    steerable_pipeline_g4,
)
