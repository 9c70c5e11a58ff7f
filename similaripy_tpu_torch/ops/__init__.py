"""Host CSR plumbing and device segment ops."""
