"""Datasets and test-data generation (the reference's data/ directory)."""
from ..models.logreg import load_csv as load_label_csv  # noqa: F401
from .generator import (  # noqa: F401
    create_random_good_test_data,
    synthetic_classification_csv,
)
