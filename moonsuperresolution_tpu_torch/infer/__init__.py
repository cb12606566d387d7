"""Large-raster inference."""
