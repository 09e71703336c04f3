"""Scored re-ranking tables: packed codes -> calibrated similarity
scores (counterpart of ``repro/rank``)."""
from repro_torch.rank.tables import RankTables, build_rank_tables  # noqa: F401
