"""Layers, grouper, graph attention, transformer stacks and heads (eval forms)."""
