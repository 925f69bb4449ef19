"""Models: configuration, parameter interop and the paged decoder stack."""
