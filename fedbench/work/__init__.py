"""The work of a round and of a kernel, from shapes alone: a roofline
share reads the same work whatever implements it."""
