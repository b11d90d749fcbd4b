// The C++ issue path of a warm async allreduce on a CUDA communicator.
//
// run_async (collectives/eager.py) issues an allreduce whose plan the
// schedule compiler has already bound with one call here instead of the
// Python sequence it replaces: record the reused ordering event on the
// caller's current stream and make the side stream wait on it, switch to
// the side stream, run the plan's work there (the vendor path's three
// ATen calls, or one launch of K3, tm_ring_allreduce of ring_kernels.cu,
// through its C entry point), record the handle's done event, switch back
// and keep the input alive until the side stream has read it
// (record_stream). The work is the same as the Python path's, so the bits
// are too.
//
// Built by ops/_build.py with the host C++ compiler against the installed
// PyTorch headers, loaded as the Python module tm_issue; ops/issue.py is
// its wrapper. The torch.cuda.Stream and torch.cuda.Event arguments are
// read through PyTorch's own object layouts (THCPStream, THCPEvent), after
// a type check against the classes bind() was given (PyTorch does not
// export its own class pointers to extensions).

#include <ATen/ATen.h>
#include <ATen/cuda/CUDAEvent.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/autograd/python_variable.h>
#include <torch/csrc/cuda/Event.h>
#include <torch/csrc/cuda/Stream.h>

#include <string>

namespace {

// tm_ring_allreduce(x, out, dtype, rows, groups, n, chunk_elems, stream)
using RingAllreduce = int (*)(const void*, void*, int, int, int, long long, long long,
                              void*);

enum Route : long { kVendor = 0, kRing = 1 };

// torch._C._CudaStreamBase and torch._C._CudaEventBase, from bind()
PyTypeObject* stream_type = nullptr;
PyTypeObject* event_type = nullptr;

PyObject* fail(PyObject* type, const std::string& what) {
  PyErr_SetString(type, what.c_str());
  return nullptr;
}

// issue(x, side_stream, order_event, done_event, fn, route, dtype, n, chunk)
// -> the output tensor. fn is the address of tm_ring_allreduce for the
// kernel route (0 for the vendor route); dtype, n and chunk are its
// arguments (per-rank elements and ring chunk elements).
PyObject* issue(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 9) {
    return fail(PyExc_TypeError, "issue takes 9 arguments");
  }
  if (stream_type == nullptr || !THPVariable_Check(args[0]) ||
      !PyObject_TypeCheck(args[1], stream_type) || !PyObject_TypeCheck(args[2], event_type) ||
      !PyObject_TypeCheck(args[3], event_type)) {
    return fail(PyExc_TypeError,
                "issue(x, torch.cuda.Stream, torch.cuda.Event, torch.cuda.Event, ...)");
  }
  long long ints[5];
  for (int i = 0; i < 5; ++i) {
    ints[i] = PyLong_AsLongLong(args[4 + i]);
    if (ints[i] == -1 && PyErr_Occurred()) {
      return nullptr;
    }
  }
  const auto fn = reinterpret_cast<RingAllreduce>(static_cast<intptr_t>(ints[0]));
  const long route = static_cast<long>(ints[1]);
  try {
    const at::Tensor& x = THPVariable_Unpack(args[0]);
    const at::cuda::CUDAStream side = reinterpret_cast<THCPStream*>(args[1])->cuda_stream;
    at::cuda::CUDAEvent& order = reinterpret_cast<THCPEvent*>(args[2])->cuda_event;
    at::cuda::CUDAEvent& done = reinterpret_cast<THCPEvent*>(args[3])->cuda_event;
    if (!x.is_cuda() || x.dim() < 1) {
      return fail(PyExc_ValueError, "issue takes a rank-stacked CUDA tensor");
    }
    order.record(c10::cuda::getCurrentCUDAStream(x.get_device()));
    order.block(side);
    at::Tensor out;
    {
      // the side stream (and its device) current until the scope ends
      c10::cuda::CUDAStreamGuard guard(side);
      const at::Tensor xc = x.contiguous();
      if (route == kVendor) {
        // primitives.allreduce: every rank gets the sum over the rank axis
        out = xc.sum(0, /*keepdim=*/true, xc.scalar_type()).expand_as(xc).contiguous();
      } else if (route == kRing && fn != nullptr) {
        out = at::empty_like(xc, at::MemoryFormat::Contiguous);
        // one ring over all the rows (one group)
        const int err = fn(xc.data_ptr(), out.data_ptr(), static_cast<int>(ints[2]),
                           static_cast<int>(xc.size(0)), 1, ints[3], ints[4], side.stream());
        if (err != 0) {
          return fail(PyExc_RuntimeError,
                      "tm_ring_allreduce: CUDA error " + std::to_string(err) + " at launch");
        }
      } else {
        return fail(PyExc_ValueError, "issue: unknown route " + std::to_string(route));
      }
      done.record(side);
    }
    x.record_stream(side.unwrap());
    return THPVariable_Wrap(std::move(out));
  } catch (const std::exception& e) {
    return fail(PyExc_RuntimeError, e.what());
  }
}

// bind(stream_class, event_class): the classes issue() checks against
PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 2 || !PyType_Check(args[0]) || !PyType_Check(args[1])) {
    return fail(PyExc_TypeError, "bind takes the CUDA stream and event classes");
  }
  Py_INCREF(args[0]);
  Py_INCREF(args[1]);
  stream_type = reinterpret_cast<PyTypeObject*>(args[0]);
  event_type = reinterpret_cast<PyTypeObject*>(args[1]);
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"bind", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(bind)), METH_FASTCALL,
     "Give the CUDA stream and event classes that issue() takes."},
    {"issue", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(issue)),
     METH_FASTCALL, "Issue a warm async allreduce on the side stream."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module_def = {PyModuleDef_HEAD_INIT, "tm_issue", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_tm_issue() { return PyModule_Create(&module_def); }
