"""ClimEx data: synthetic fields, physical transforms, host ingest
(``ClimexDataset``, the packed artifact), device-side preprocessing and
batch iteration."""
