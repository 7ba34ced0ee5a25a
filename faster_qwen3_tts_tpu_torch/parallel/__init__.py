"""The (dp, tp) device mesh (`parallel.mesh`)."""
