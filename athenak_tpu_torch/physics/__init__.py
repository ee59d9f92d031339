"""Physics modules."""
