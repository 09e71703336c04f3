"""Linear-classifier training directly on packed codes (paper §6).

Counterpart of ``repro.learn``: linear SVMs on the one-hot expansion of
the coded projections without building the one-hot matrix; the feature
dot product is a per-projection weight-table gather, so training runs on
the same packed words the search engines serve from.

features — ``PackedFeatureSpec``: the flat [k, 2^b] table layout shared
           with ``rank.RankTables``, phantom-column masking, row
           normalization as a scalar pre-scale, dense <-> packed weight
           converters; ``expand_codes`` (the dense oracle path)
linear   — ``PackedLinearModel`` and ``train_packed_linear``: squared
           hinge and logistic objectives, margins and gradients through
           the packed-linear kernels, Adam with cosine decay on buffers
           updated in place
trainer  — ``fit_words`` (full batch and minibatch), ``fit_store`` off a
           ``CodeStore``, ``fit_log`` over a churning ``SegmentLogStore``
           with labels keyed by external id

(dense compat wrapper: ``repro_torch.core.svm``)
"""
from repro_torch.learn.features import (PackedFeatureSpec,  # noqa: F401
                                        expand_codes, feature_spec_for)
from repro_torch.learn.linear import (LearnConfig,  # noqa: F401
                                      PackedLinearModel, train_dense_linear,
                                      train_packed_linear)
from repro_torch.learn.trainer import (fit_log, fit_store,  # noqa: F401
                                       fit_words, packed_grads_sharded)
