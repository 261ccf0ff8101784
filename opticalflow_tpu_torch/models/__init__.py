"""The PWC-DC network and weight carry-over."""
