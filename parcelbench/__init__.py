"""The benchmark of xarray_parcel_tpu_torch: ``run.py`` runs one cell once."""
