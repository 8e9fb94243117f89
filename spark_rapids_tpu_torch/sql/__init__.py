"""SQL frontend of the PyTorch port: `parser.parse_sql`."""
