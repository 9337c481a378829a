"""PyTorch port vs the JAX reference: BART's GLUE head calibrated under
OliVe ("ant-int-flint" with OVP, bounds 75-250), held as
``tests/test_torch_bart.py:check_calibrated`` holds the ANT cases (the
tree rule, near-ties checked at the first site, the calibrating
forwards' outputs within 5e-3). A file of its own because the
reference's eager OliVe calibration takes about 30 s of the CPU.
"""

import pytest

from test_torch_bart import check_calibrated

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep


def test_calibrated_fake_quant_against_jax_olive():
    check_calibrated("cls", "olive")
