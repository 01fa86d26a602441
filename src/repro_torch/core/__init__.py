"""Job table, policies, event engine and metrics of the PyTorch port."""
