"""The host C++ runtime (``libbatchelor.cpp``) and its ctypes bindings."""
