"""The post stage (wasspost) on the port: spectra, filters, visibility,
radiance and polarimetric averages over gridded cubes."""
