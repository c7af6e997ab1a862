"""Host utilities of the port (port of parq_tpu/utils/): `vis`, the
wireframe overlays, feature-map PCA and PNG files."""
