// Symmetric slabs for ranks spread over several processes on one card.
//
// runtime/peers.py gives each communicator, in each process, one slab of
// device memory that the other processes map: a process copies its rank
// rows into its own slab, and the cross-process forms of K3 and K7 (and the
// ring backend's copies) read every process's rows straight from the
// slabs. A slab is one cudaMalloc of its own, exported with
// cudaIpcGetMemHandle: an IPC handle names a whole allocation, so the
// caching allocator's blocks (which share allocations) cannot serve. A peer
// maps it once with cudaIpcOpenMemHandle; the handles travel once a slab,
// over the control plane, not once a call.
//
// alloc(nbytes, device) -> (uint8 tensor over the allocation, handle bytes)
// open(handle, nbytes, device) -> uint8 tensor over the peer's allocation
//
// Each tensor is a torch::from_blob view whose deleter undoes the call that
// made it (cudaFree, cudaIpcCloseMemHandle), on the tensor's device, when
// the last reference to it goes. Built by ops/_build.py with the host C++
// compiler against the installed PyTorch headers, loaded as tm_peer.

#include <ATen/ATen.h>
#include <cuda_runtime.h>
#include <torch/csrc/autograd/python_variable.h>

#include <cstring>
#include <string>

namespace {

PyObject* fail(PyObject* type, const std::string& what) {
  PyErr_SetString(type, what.c_str());
  return nullptr;
}

std::string cuda_error(const char* what, cudaError_t err) {
  return std::string(what) + ": " + cudaGetErrorString(err);
}

// Runs the deleter's call on the allocation's device, restoring the
// current device after.
template <typename F>
void on_device(int device, F&& f) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  f();
  cudaSetDevice(prev);
}

at::Tensor view_of(void* ptr, long long nbytes, int device, void (*release)(void*, int)) {
  auto opts = at::TensorOptions().dtype(at::kByte).device(at::kCUDA, device);
  return at::from_blob(
      ptr, {nbytes}, [device, release](void* p) { release(p, device); }, opts);
}

void free_slab(void* p, int device) {
  on_device(device, [p] { cudaFree(p); });
}

void close_mapping(void* p, int device) {
  on_device(device, [p] { cudaIpcCloseMemHandle(p); });
}

bool long_args(PyObject* const* args, int count, long long* out) {
  for (int i = 0; i < count; ++i) {
    out[i] = PyLong_AsLongLong(args[i]);
    if (out[i] == -1 && PyErr_Occurred()) return false;
  }
  return true;
}

// alloc(nbytes, device)
PyObject* alloc(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 2) return fail(PyExc_TypeError, "alloc(nbytes, device)");
  long long v[2];
  if (!long_args(args, 2, v)) return nullptr;
  const long long nbytes = v[0];
  const int device = static_cast<int>(v[1]);
  if (nbytes <= 0) return fail(PyExc_ValueError, "alloc: nbytes must be positive");
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  void* ptr = nullptr;
  cudaError_t err = cudaMalloc(&ptr, static_cast<size_t>(nbytes));
  cudaIpcMemHandle_t handle;
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(&handle, ptr);
    if (err != cudaSuccess) cudaFree(ptr);
  }
  cudaSetDevice(prev);
  if (err != cudaSuccess) return fail(PyExc_RuntimeError, cuda_error("alloc", err));
  try {
    at::Tensor t = view_of(ptr, nbytes, device, free_slab);
    PyObject* tensor = THPVariable_Wrap(std::move(t));
    if (tensor == nullptr) return nullptr;
    PyObject* bytes = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(&handle),
                                                sizeof(handle));
    if (bytes == nullptr) {
      Py_DECREF(tensor);
      return nullptr;
    }
    PyObject* pair = PyTuple_Pack(2, tensor, bytes);
    Py_DECREF(tensor);
    Py_DECREF(bytes);
    return pair;
  } catch (const std::exception& e) {
    return fail(PyExc_RuntimeError, e.what());
  }
}

// open(handle, nbytes, device)
PyObject* open_handle(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 3 || !PyBytes_Check(args[0])) {
    return fail(PyExc_TypeError, "open(handle bytes, nbytes, device)");
  }
  if (PyBytes_Size(args[0]) != static_cast<Py_ssize_t>(sizeof(cudaIpcMemHandle_t))) {
    return fail(PyExc_ValueError, "open: not a CUDA IPC memory handle");
  }
  long long v[2];
  if (!long_args(args + 1, 2, v)) return nullptr;
  const long long nbytes = v[0];
  const int device = static_cast<int>(v[1]);
  cudaIpcMemHandle_t handle;
  std::memcpy(&handle, PyBytes_AsString(args[0]), sizeof(handle));
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  void* ptr = nullptr;
  const cudaError_t err = cudaIpcOpenMemHandle(&ptr, handle, cudaIpcMemLazyEnablePeerAccess);
  cudaSetDevice(prev);
  if (err != cudaSuccess) return fail(PyExc_RuntimeError, cuda_error("open", err));
  try {
    return THPVariable_Wrap(view_of(ptr, nbytes, device, close_mapping));
  } catch (const std::exception& e) {
    return fail(PyExc_RuntimeError, e.what());
  }
}

PyMethodDef methods[] = {
    {"alloc", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(alloc)), METH_FASTCALL,
     "One cudaMalloc exported for other processes: (uint8 tensor, IPC handle bytes)."},
    {"open", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(open_handle)),
     METH_FASTCALL, "Map a peer's slab from its IPC handle: a uint8 tensor."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {PyModuleDef_HEAD_INIT, "tm_peer", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_tm_peer() { return PyModule_Create(&module_def); }
