"""Device-resident exact search over packed codes: ``CodeStore``, band
hashes, ``AnnEngine``."""
from repro_torch.ann.bands import BandSpec, band_hashes, probe_hashes  # noqa: F401
from repro_torch.ann.engine import AnnEngine, SearchConfig  # noqa: F401
from repro_torch.ann.store import CodeStore  # noqa: F401
