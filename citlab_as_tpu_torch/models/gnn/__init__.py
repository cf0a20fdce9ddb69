"""Relation GNN of the port (``GraphRelation``) and its host-side graph
helpers."""
