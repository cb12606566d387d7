"""GeoTIFF I/O (counterpart of moonsuperresolution_tpu/geo)."""
