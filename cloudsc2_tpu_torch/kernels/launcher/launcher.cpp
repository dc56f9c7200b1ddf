// The kernel wrappers' per-call launch path, compiled: one call checks a
// launch's inputs, allocates its outputs, refuses an output that overlaps an
// input and calls the kernel library's C entry, on PyTorch's current stream
// on the card.  A Launcher is made once per launch plan
// (kernels/nonlinear.py LaunchPlan) from what the plan worked out: the
// entry's address, its int switches, the constant struct's bytes, the
// inputs' names and shapes and the outputs'.  It is the one implementation
// of the checks on a launch's state; its overlap rule is also
// kernels/nonlinear.py check_disjoint's.  Every input refusal comes before
// any output is allocated.
//
// Built by kernels/build.py launcher() with g++ against the installed
// torch's headers and libraries, as a Python module (pybind11).  With
// CLOUDSC2_LAUNCHER_CUDA=1 (a CUDA build of torch) it launches on the card
// too; a host build of a kernel takes it the same way, with no stream.
#include <Python.h>
#include <pybind11/pybind11.h>
#include <pybind11/stl.h>
#include <torch/csrc/autograd/python_variable.h>
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#if CLOUDSC2_LAUNCHER_CUDA
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <algorithm>
#include <cstdint>
#include <ctime>
#include <optional>
#include <string>
#include <tuple>
#include <utility>
#include <vector>

namespace py = pybind11;

namespace {

// The clock of the port's spans: time.time_ns() (CLOCK_REALTIME), in ns.
int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

// A shape as Python prints a tuple of ints: "(137, 12)", "(137,)".
std::string tuple_str(c10::IntArrayRef shape) {
  std::string s = "(";
  for (std::size_t i = 0; i < shape.size(); ++i) {
    if (i) s += ", ";
    s += std::to_string(shape[i]);
  }
  return s + (shape.size() == 1 ? ",)" : ")");
}

std::string quoted(const std::string& name) { return "'" + name + "'"; }

py::str interned(const std::string& name) {
  return py::reinterpret_steal<py::str>(PyUnicode_InternFromString(name.c_str()));
}

// The test seam of the outputs' allocation: a callable (shape, dtype,
// device) -> Tensor that takes at::empty's place while it is set.
PyObject* alloc_seam = nullptr;

// The first output that overlaps an input and its first input, by index, or
// none: one sweep over the spans sorted by address finds whether any output
// overlaps an input (a span that starts before the furthest end of the
// other kind so far); only then are the pairs searched.  A null address is
// a field the kernel does not take.
std::optional<std::pair<std::size_t, std::size_t>> first_overlap(
    const std::vector<uintptr_t>& in_ptrs, const std::vector<uint64_t>& in_bytes,
    const std::vector<uintptr_t>& out_ptrs, const std::vector<uint64_t>& out_bytes) {
  std::vector<std::tuple<uintptr_t, uintptr_t, int>> spans;
  spans.reserve(in_ptrs.size() + out_ptrs.size());
  for (std::size_t i = 0; i < in_ptrs.size(); ++i)
    if (in_ptrs[i]) spans.emplace_back(in_ptrs[i], in_ptrs[i] + in_bytes[i], 0);
  for (std::size_t i = 0; i < out_ptrs.size(); ++i)
    if (out_ptrs[i]) spans.emplace_back(out_ptrs[i], out_ptrs[i] + out_bytes[i], 1);
  std::sort(spans.begin(), spans.end());
  uintptr_t ends[2] = {0, 0};
  bool found = false;
  for (const auto& [lo, hi, kind] : spans) {
    if (lo < ends[1 - kind]) {
      found = true;
      break;
    }
    ends[kind] = std::max(ends[kind], hi);
  }
  if (!found) return std::nullopt;
  for (std::size_t o = 0; o < out_ptrs.size(); ++o)
    for (std::size_t i = 0; i < in_ptrs.size(); ++i) {
      const uintptr_t p = in_ptrs[i], q = out_ptrs[o];
      if (p && q && q < p + in_bytes[i] && p < q + out_bytes[o]) return std::make_pair(o, i);
    }
  return std::nullopt;
}

[[noreturn]] void refuse_overlap(const std::string& output, const std::string& input) {
  throw py::value_error("output " + quoted(output) + " overlaps input " + quoted(input) +
                        "; the kernel needs them apart");
}

// Call a C entry of `nsw` int switches (5, 6 or 7), then the pointer
// arrays, the constant struct, nlev and ncols, and the stream where the
// entry takes one (a CUDA library's).
template <std::size_t... I>
int call_entry(void* fn, const int* sw, std::index_sequence<I...>, const void* const* in, void* const* out,
               const void* consts, int nlev, int ncols, bool with_stream, void* stream) {
  if (with_stream) {
    using F = int (*)(decltype((void)I, int())..., const void* const*, void* const*, const void*, int, int, void*);
    return reinterpret_cast<F>(fn)(sw[I]..., in, out, consts, nlev, ncols, stream);
  }
  using F = int (*)(decltype((void)I, int())..., const void* const*, void* const*, const void*, int, int);
  return reinterpret_cast<F>(fn)(sw[I]..., in, out, consts, nlev, ncols);
}

int call_entry(void* fn, const std::vector<int>& sw, const void* const* in, void* const* out, const void* consts,
               int nlev, int ncols, bool with_stream, void* stream) {
  switch (sw.size()) {
    case 5: return call_entry(fn, sw.data(), std::make_index_sequence<5>(), in, out, consts, nlev, ncols,
                              with_stream, stream);
    case 6: return call_entry(fn, sw.data(), std::make_index_sequence<6>(), in, out, consts, nlev, ncols,
                              with_stream, stream);
    case 7: return call_entry(fn, sw.data(), std::make_index_sequence<7>(), in, out, consts, nlev, ncols,
                              with_stream, stream);
  }
  throw std::logic_error("no C entry takes " + std::to_string(sw.size()) + " switches");
}

class Launcher {
 public:
  // fn: the C entry's address; cuda: a CUDA library's entry (on the card,
  // with a stream) or a host build's; switches, consts: the entry's int
  // switches and constant struct; inputs: the kernel's inputs in order, a
  // name or None for one it does not read, `eta` among them; in_shapes:
  // their shapes (None where not read); outputs: the kernel's outputs in
  // order; out_shapes: their shapes (None for one it does not write);
  // is_double: the dtype; device_type: "cpu" or "cuda"; failure: the error
  // of a refused launch, "{}" its code.
  Launcher(uintptr_t fn, bool cuda, std::vector<int> switches, py::bytes consts, py::tuple inputs,
           py::tuple in_shapes, py::tuple outputs, py::tuple out_shapes, bool is_double, std::string device_type,
           std::string failure, int nlev, int ncols)
      : fn_(reinterpret_cast<void*>(fn)), cuda_(cuda), switches_(std::move(switches)), consts_(consts),
        dtype_(is_double ? at::kDouble : at::kFloat), dtype_str_(is_double ? "torch.float64" : "torch.float32"),
        device_type_(device_type == "cuda" ? c10::DeviceType::CUDA : c10::DeviceType::CPU),
        device_type_str_(std::move(device_type)), failure_(std::move(failure)), nlev_(nlev), ncols_(ncols) {
#if !CLOUDSC2_LAUNCHER_CUDA
    if (cuda_) throw std::invalid_argument("this launcher was built without CUDA");
#endif
    const std::size_t item = is_double ? 8 : 4;
    // a shape from the plan (empty for None) and its bytes
    auto dims = [](py::handle h) {
      return h.is_none() ? std::vector<int64_t>{} : py::cast<std::vector<int64_t>>(h);
    };
    auto bytes = [&](const std::vector<int64_t>& s) {
      uint64_t b = s.empty() ? 0 : item;
      for (auto d : s) b *= static_cast<uint64_t>(d);
      return b;
    };
    for (std::size_t i = 0; i < inputs.size(); ++i) {
      const bool reads = !inputs[i].is_none();
      in_names_.push_back(reads ? py::cast<std::string>(inputs[i]) : std::string());
      in_keys_.push_back(reads ? interned(in_names_.back()) : py::str());
      in_shapes_.push_back(dims(in_shapes[i]));
      in_bytes_.push_back(bytes(in_shapes_.back()));
    }
    // the order of the checks: the fields taken from the state, then eta
    for (std::size_t i = 0; i < in_names_.size(); ++i)
      if (!in_names_[i].empty() && in_names_[i] != "eta") order_.push_back(i);
    for (std::size_t i = 0; i < in_names_.size(); ++i)
      if (in_names_[i] == "eta") eta_ = static_cast<int>(i);
    if (eta_ < 0) throw std::invalid_argument("a launch reads eta");
    order_.push_back(static_cast<std::size_t>(eta_));
    for (std::size_t o = 0; o < outputs.size(); ++o) {
      out_names_.push_back(py::cast<std::string>(outputs[o]));
      out_keys_.push_back(interned(out_names_.back()));
      out_shapes_.push_back(dims(out_shapes[o]));
      out_bytes_.push_back(bytes(out_shapes_.back()));
    }
  }

  // One launch on the state (a mapping of names to tensors; `extra`, where
  // not None, looked up first: the AD's trajectory) and `eta` (None: the
  // state's, in the launch's dtype).  Returns (the outputs by name, None
  // for one not written; the eta the kernel read; with `timed` the five
  // stamps on the spans' clock that bound the stages check, alloc, check
  // (the overlap) and launch, else None).  Raises ValueError, TypeError or
  // KeyError on a state the kernel does not take (a field's shape, dtype,
  // device or layout, or a field missing), ValueError on an output that
  // overlaps an input, and RuntimeError on a refused launch.
  py::tuple run(py::handle state, py::handle extra, py::handle eta, bool timed) {
    int64_t t[5] = {0, 0, 0, 0, 0};
    if (timed) t[0] = now_ns();
    const std::size_t n_in = in_names_.size();
    // check: every field looked up, then each checked, in order_
    const py::object ap_obj = lookup(state, extra, 0);
    const at::Tensor& ap = tensor(ap_obj.ptr(), 0);
    const c10::Device device = ap.device();
    if (device.type() != device_type_)
      throw py::value_error("tensors must be on " + device_type_str_ + ", got " + device.str());
    py::object eta_obj;
    if (eta.is_none()) {
      eta_obj = lookup(state, extra, eta_);
      const at::Tensor& e = tensor(eta_obj.ptr(), eta_);
      if (e.scalar_type() != dtype_) eta_obj = py::reinterpret_steal<py::object>(THPVariable_Wrap(e.to(dtype_)));
    } else {
      eta_obj = py::reinterpret_borrow<py::object>(eta);
    }
    std::vector<py::object> fields(n_in);
    for (std::size_t i : order_) fields[i] = static_cast<int>(i) == eta_ ? eta_obj : lookup(state, extra, i);
    std::vector<uintptr_t> in_ptrs(n_in, 0);
    for (std::size_t i : order_) {
      const at::Tensor& v = tensor(fields[i].ptr(), i);
      check(v, i, device, fields[i]);
      in_ptrs[i] = reinterpret_cast<uintptr_t>(v.data_ptr());
    }
    if (timed) t[1] = now_ns();
    // alloc
    const std::size_t n_out = out_names_.size();
    std::vector<at::Tensor> outs(n_out);
    const auto options = at::TensorOptions().dtype(dtype_).device(device);
    for (std::size_t o = 0; o < n_out; ++o)
      if (!out_shapes_[o].empty()) outs[o] = alloc(out_shapes_[o], options, ap_obj);
    if (timed) t[2] = now_ns();
    // check: no output overlaps an input
    std::vector<uintptr_t> out_ptrs(n_out, 0);
    for (std::size_t o = 0; o < n_out; ++o)
      if (outs[o].defined()) out_ptrs[o] = reinterpret_cast<uintptr_t>(outs[o].data_ptr());
    if (auto hit = first_overlap(in_ptrs, in_bytes_, out_ptrs, out_bytes_))
      refuse_overlap(out_names_[hit->first], in_names_[hit->second]);
    if (timed) t[3] = now_ns();
    // launch
    int err = 0;
    {
      const auto* in = reinterpret_cast<const void* const*>(in_ptrs.data());
      auto* out = reinterpret_cast<void* const*>(out_ptrs.data());
      const void* consts = PyBytes_AS_STRING(consts_.ptr());
      if (cuda_) {
#if CLOUDSC2_LAUNCHER_CUDA
        const c10::cuda::CUDAGuard guard(device);
        void* stream = c10::cuda::getCurrentCUDAStream(device.index()).stream();
        err = call_entry(fn_, switches_, in, out, consts, nlev_, ncols_, true, stream);
#endif
      } else {
        // a host body runs the whole step: other threads run meanwhile
        const py::gil_scoped_release unlocked;
        err = call_entry(fn_, switches_, in, out, consts, nlev_, ncols_, false, nullptr);
      }
    }
    if (timed) t[4] = now_ns();
    if (err != 0) {
      std::string msg = failure_;
      const auto at = msg.find("{}");
      if (at != std::string::npos) msg.replace(at, 2, std::to_string(err));
      throw std::runtime_error(msg);
    }
    py::dict named;
    for (std::size_t o = 0; o < n_out; ++o) {
      if (outs[o].defined())
        named[out_keys_[o]] = py::reinterpret_steal<py::object>(THPVariable_Wrap(std::move(outs[o])));
      else
        named[out_keys_[o]] = py::none();
    }
    py::object stamps = timed ? py::object(py::make_tuple(t[0], t[1], t[2], t[3], t[4])) : py::object(py::none());
    return py::make_tuple(named, eta_obj, stamps);
  }

 private:
  // The field of input i: from `extra` where it holds it, else the state's;
  // KeyError (the name) where neither does.
  py::object lookup(py::handle state, py::handle extra, std::size_t i) const {
    PyObject* key = in_keys_[i].ptr();
    if (!extra.is_none()) {
      if (py::object v = get(extra.ptr(), key, false)) return v;
    }
    return get(state.ptr(), key, true);
  }

  static py::object get(PyObject* mapping, PyObject* key, bool required) {
    if (PyDict_CheckExact(mapping)) {
      if (PyObject* v = PyDict_GetItemWithError(mapping, key)) return py::reinterpret_borrow<py::object>(v);
      if (PyErr_Occurred()) throw py::error_already_set();
      if (!required) return py::object();
      PyErr_SetObject(PyExc_KeyError, key);
      throw py::error_already_set();
    }
    if (!required) {
      const int has = PySequence_Contains(mapping, key);
      if (has < 0) throw py::error_already_set();
      if (!has) return py::object();
    }
    PyObject* v = PyObject_GetItem(mapping, key);
    if (!v) throw py::error_already_set();
    return py::reinterpret_steal<py::object>(v);
  }

  const at::Tensor& tensor(PyObject* obj, std::size_t i) const {
    if (!THPVariable_Check(obj)) throw py::type_error("field " + quoted(in_names_[i]) + " is not a tensor");
    return THPVariable_Unpack(obj);
  }

  void check(const at::Tensor& v, std::size_t i, c10::Device device, const py::object& obj) const {
    const auto& want = in_shapes_[i];
    const bool shape_ok = v.sizes().equals(want);
    if (shape_ok && v.scalar_type() == dtype_ && v.device() == device && v.is_contiguous()) return;
    const std::string n = quoted(in_names_[i]);
    if (!shape_ok) throw py::value_error("field " + n + " has shape " + tuple_str(v.sizes()) + ", want " + tuple_str(want));
    if (v.scalar_type() != dtype_)
      throw py::type_error("field " + n + " has dtype " + py::str(obj.attr("dtype")).cast<std::string>() + ", want " +
                           dtype_str_);
    if (v.device() != device)
      throw py::value_error("field " + n + " is on " + v.device().str() + ", want " + device.str());
    throw py::value_error("field " + n + " is not contiguous");
  }

  // An output's storage (the kernel writes every element): at::empty, or
  // the test seam's, called with the shape and the dtype and device of ap.
  at::Tensor alloc(const std::vector<int64_t>& shape, const at::TensorOptions& options, const py::object& ap) const {
    if (!alloc_seam) return at::empty(shape, options);
    py::object got = py::reinterpret_borrow<py::object>(alloc_seam)(py::tuple(py::cast(shape)), ap.attr("dtype"),
                                                                      ap.attr("device"));
    if (!THPVariable_Check(got.ptr())) throw py::type_error("the allocation seam returned no tensor");
    return THPVariable_Unpack(got.ptr());
  }

  void* fn_;
  bool cuda_;
  std::vector<int> switches_;
  py::bytes consts_;
  at::ScalarType dtype_;
  std::string dtype_str_;
  c10::DeviceType device_type_;
  std::string device_type_str_;
  std::string failure_;
  int nlev_, ncols_;
  std::vector<std::string> in_names_;  // "" for an input not read
  std::vector<py::str> in_keys_;
  std::vector<std::vector<int64_t>> in_shapes_;
  std::vector<uint64_t> in_bytes_;
  std::vector<std::size_t> order_;
  int eta_ = -1;
  std::vector<std::string> out_names_;
  std::vector<py::str> out_keys_;
  std::vector<std::vector<int64_t>> out_shapes_;  // empty: not written
  std::vector<uint64_t> out_bytes_;
};

}  // namespace

// CLOUDSC2_LAUNCHER_MODULE: cloudsc2_launcher_<the build's hash> (kernels/build.py launcher())
PYBIND11_MODULE(CLOUDSC2_LAUNCHER_MODULE, m) {
  m.doc() = "The kernel wrappers' per-call launch path (kernels/launcher/launcher.cpp).";
  py::class_<Launcher>(m, "Launcher")
      .def(py::init<uintptr_t, bool, std::vector<int>, py::bytes, py::tuple, py::tuple, py::tuple, py::tuple, bool,
                    std::string, std::string, int, int>())
      .def("run", &Launcher::run, py::arg("state"), py::arg("extra"), py::arg("eta"), py::arg("timed"));
  m.def("check_spans",
        [](std::vector<uintptr_t> in_ptrs, std::vector<uint64_t> in_bytes, std::vector<std::string> in_names,
           std::vector<uintptr_t> out_ptrs, std::vector<uint64_t> out_bytes, std::vector<std::string> out_names) {
          if (auto hit = first_overlap(in_ptrs, in_bytes, out_ptrs, out_bytes))
            refuse_overlap(out_names.at(hit->first), in_names.at(hit->second));
        },
        "Raise ValueError where an output's span overlaps an input's (check_disjoint's rule).");
  m.def("set_alloc_seam",
        [](py::object fn) {
          Py_XDECREF(alloc_seam);
          alloc_seam = fn.is_none() ? nullptr : fn.release().ptr();
        },
        "Allocate the outputs through fn(shape, dtype, device) instead of at::empty (None: at::empty); tests only.");
}
