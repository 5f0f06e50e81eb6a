"""Device selection, metrics, and weights carried over from JAX or a
reference checkpoint."""
