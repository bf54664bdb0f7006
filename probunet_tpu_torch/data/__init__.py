"""ClimEx data: synthetic fields, physical transforms, device-side
preprocessing (the ingest side of ``probunet_tpu.data`` is not ported)."""
