"""VeilGraph core on PyTorch: hot-vertex selection, big-vertex summaries and
the summarized power iteration behind the ``StreamingAlgorithm`` interface,
over one ``push`` primitive.

The names are those of the JAX package's ``repro.core``, from the port's
modules, but ``resolve_backend``: the port has no backend names, it picks
each push's kernel by the device of its tensors."""
from repro_torch.core.algorithm import (Action, AlgoState,
                                        ConnectedComponentsAlgorithm,
                                        HITSAlgorithm, KatzAlgorithm,
                                        PageRankAlgorithm,
                                        PersonalizedPageRankAlgorithm,
                                        SSSPAlgorithm, StreamingAlgorithm,
                                        algorithm_factory,
                                        available_algorithms, make_algorithm,
                                        register_algorithm)
from repro_torch.core.backend import (EdgeLayout, ShardedEdgeLayout,
                                      build_layout, push, push_coo,
                                      summary_layout)
from repro_torch.core.engine import EngineConfig, QueryStats, VeilGraphEngine
from repro_torch.core.hits import hits, summarized_hits
from repro_torch.core.hotset import HotSetStats, select_hot_set
from repro_torch.core.katz import katz, summarized_katz
from repro_torch.core.pagerank import (SummaryBuffers, build_summary,
                                       pagerank, summarized_pagerank)
from repro_torch.core.semiring import (Semiring, available_semirings,
                                       register_semiring, resolve_semiring)
from repro_torch.core.traversal import (connected_components, sssp,
                                        summarized_connected_components,
                                        summarized_sssp)
