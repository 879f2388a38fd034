import os
import sys

# run.py and calibrate.py are scripts beside the package; the tests import them.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
