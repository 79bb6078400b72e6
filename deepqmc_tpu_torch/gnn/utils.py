"""Node and edge types of the molecular graph (counterpart of
``deepqmc_tpu/gnn/utils.py``): which node type receives and which sends
along each edge type, and lookups of a graph's data by type.

Besides the JAX package's ``node_data``, a layer's mapping carries the
widths of the graph it receives (``node_data['dims']``: a width per node
type present and per edge type), from which the port's update features size
their networks when they are built.
"""

from collections import namedtuple
from typing import Optional

__all__ = ['GraphNodes', 'NodeEdgeMapping', 'is_edge', 'is_node']

GraphNodes = namedtuple('GraphNodes', 'nuclei electrons')

_RECEIVER_OF = {
    'same': 'electrons',
    'anti': 'electrons',
    'ne': 'electrons',
    'en': 'nuclei',
    'nn': 'nuclei',
    'up': 'electrons',
    'down': 'electrons',
}
_SENDER_OF = {
    'same': 'electrons',
    'anti': 'electrons',
    'ne': 'nuclei',
    'en': 'electrons',
    'nn': 'nuclei',
    'up': 'electrons',
    'down': 'electrons',
}


def _get(container, key):
    try:
        return getattr(container, key)
    except AttributeError:
        return container[key]


def _keys(container):
    try:
        return list(container._fields)
    except AttributeError:
        return list(container.keys())


def is_node(label: str) -> bool:
    return label in {'nuclei', 'electrons'}


def is_edge(label: str) -> bool:
    return label in _RECEIVER_OF


class NodeEdgeMapping:
    """Lookup helper between node types and the edges touching them."""

    def __init__(self, edges, node_data: Optional[dict] = None):
        self.edges = edges
        self.nodes = {self.receiver_of(edge) for edge in edges}
        self.node_data = node_data

    @property
    def dims(self) -> dict:
        """The widths of the received graph: node type or edge type -> width."""
        return self.node_data['dims']

    def get_data_container(self, data):
        assert self.node_data is not None
        return self.node_data[data] if isinstance(data, str) else data

    def receiver_of(self, edge):
        return _RECEIVER_OF[edge]

    def sender_of(self, edge):
        return _SENDER_OF[edge]

    def with_receiver(self, node_or_edge):
        if is_edge(node_or_edge):
            return [node_or_edge]
        return [e for e in self.edges if self.receiver_of(e) == node_or_edge]

    def with_sender(self, node_or_edge):
        if is_edge(node_or_edge):
            return [node_or_edge]
        return [e for e in self.edges if self.sender_of(e) == node_or_edge]

    def data_with_receiver(self, node_or_edge, data):
        return [_get(data, e) for e in self.with_receiver(node_or_edge)]

    def data_with_sender(self, node_or_edge, data):
        return [_get(data, e) for e in self.with_sender(node_or_edge)]

    def node_data_of(self, node, data):
        return _get(self.get_data_container(data), node)

    def receiver_data_of(self, edge, data):
        return self.node_data_of(self.receiver_of(edge), data)

    def sender_data_of(self, edge, data):
        return self.node_data_of(self.sender_of(edge), data)

    def edge_data_of(self, edge, data):
        return _get(data, edge)

    def node_or_receiver_data_of(self, node_or_edge, data):
        if is_node(node_or_edge):
            return self.node_data_of(node_or_edge, data)
        return self.receiver_data_of(node_or_edge, data)

    def node_or_sender_data_of(self, node_or_edge, data):
        if is_node(node_or_edge):
            return self.node_data_of(node_or_edge, data)
        return self.sender_data_of(node_or_edge, data)

    def reduce_to_receiver(self, node, data, reduce_fn):
        container = self.get_data_container(data)
        if node in _keys(container):
            return _get(container, node)
        return reduce_fn(self.data_with_receiver(node, container))
