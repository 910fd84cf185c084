from repro_torch.graph.csr import SortedEdges, gather_push, sort_by_dst
from repro_torch.graph.graph import (GraphState, add_edges, compact, empty,
                                     from_edges, inv_out_degree,
                                     recompute_degrees, remove_edges_by_slot)
