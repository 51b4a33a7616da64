"""TPC-H columns, their Table-2 plans and the ``ColumnPipeline`` entry point."""
